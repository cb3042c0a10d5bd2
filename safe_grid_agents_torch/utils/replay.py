"""On-device ring replay buffer, uniform or prioritized.

Counterpart of ``safe_grid_agents_tpu/utils/replay.py``: fixed-shape
tensors with a modular write index, written in batches and sampled with
replacement, uniformly over the valid prefix or in proportion to p_i^α
(prioritized replay, Schaul et al. 2015). A ring holds one
of two records, both compact (observations are rendered at update time):

* ``Transition`` — the fused DQN trainer's compiled-env records (state
  indices and step counts), which kernel B3 writes and B4 reads;
* ``Experience`` — the array engine's transitions, whose states are the
  env's state records (``types.map_leaves`` walks their fields).

The write position and the fill level are host integers:
every push has a size the host knows, so tracking them needs no device
read. Pushes write the storage tensors in place (the JAX ring returns new
arrays); ``BufferState`` is a handle on them.

A prioritized ring keeps a dense ``[capacity]`` f32 ``priorities`` tensor
beside the storage (0 marks a slot never written), as the reference does:
no sum-tree, one softmax over masked log-priorities a draw. New records
enter at ``max(max p, (1 + eps)·clip)``, a device value (no host read);
``update_priorities`` writes back ``max(min(|δ|, clip) + eps·clip, 1e-6)``
for the sampled slots.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..types import first_leaf, map_leaves


@dataclasses.dataclass
class Transition:
    """One replay record per leading index (compiled-env ``TableState``s)."""

    s_idx: torch.Tensor   # i32 — state index
    s_t: torch.Tensor     # i32 — its episode step count
    action: torch.Tensor  # i32
    reward: torch.Tensor  # f32 — (n-step window) return
    n_idx: torch.Tensor   # i32 — bootstrap state index
    n_t: torch.Tensor     # i32
    done: torch.Tensor    # bool — bootstrap masked


@dataclasses.dataclass
class Experience:
    """One array-engine transition per leading index (counterpart of the
    JAX package's ``types.Experience``)."""

    state: Any            # the env's state record, before the step
    action: torch.Tensor  # i32
    reward: torch.Tensor  # f32 — (n-step window) return
    next_state: Any       # the pre-reset successor (n steps on)
    done: torch.Tensor    # bool — bootstrap masked


RECORD_DTYPES = dict(s_idx=torch.int32, s_t=torch.int32, action=torch.int32,
                     reward=torch.float32, n_idx=torch.int32, n_t=torch.int32,
                     done=torch.bool)


@dataclasses.dataclass
class BufferState:
    storage: Any  # a Transition or an Experience, leaves [capacity, ...]
    idx: int      # next write position
    size: int     # valid entries (≤ capacity)
    priorities: Optional[torch.Tensor] = None  # [capacity] f32 (prioritized rings)

    @property
    def capacity(self) -> int:
        return first_leaf(self.storage).shape[0]


def _empty(storage, prioritized: bool) -> BufferState:
    first = first_leaf(storage)
    pri = (torch.zeros(first.shape[0], dtype=torch.float32, device=first.device)
           if prioritized else None)
    return BufferState(storage=storage, idx=0, size=0, priorities=pri)


def init(capacity: int, device, prioritized: bool = False) -> BufferState:
    storage = Transition(**{
        k: torch.zeros(capacity, dtype=d, device=device) for k, d in RECORD_DTYPES.items()
    })
    return _empty(storage, prioritized)


def init_like(capacity: int, example, prioritized: bool = False) -> BufferState:
    """A ring of ``capacity`` records shaped like ``example``'s first
    record (its leaves ``[n, ...]``), on its device."""
    storage = map_leaves(
        lambda x: torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device), example)
    return _empty(storage, prioritized)


def _ring_positions(batch, idx: int, cap: int):
    """(batch', positions, first position, advance): ring-write plan for a
    push of n.

    When n exceeds the capacity the oldest n − cap entries of the push can
    never survive the wrap, so they are dropped and the scatter has distinct
    positions. Record t of the push lands at (idx + t) % cap, exactly as
    per-step pushes would place it."""
    n = first_leaf(batch).shape[0]
    dev = first_leaf(batch).device
    if n > cap:
        skip = n - cap
        batch = map_leaves(lambda b: b[skip:], batch)
    else:
        skip = 0
    first = (idx + skip) % cap
    pos = (first + torch.arange(min(n, cap), device=dev)) % cap
    return batch, pos, first, n


def _ring_write(storage, batch, pos: torch.Tensor, first: int, cap: int) -> None:
    """Write ``batch`` at ``pos`` (``first`` = ``pos[0]``, known on the host).
    A batch that replaces the ENTIRE ring is a roll (``storage[j] =
    batch[(j − first) % cap]``) instead of a scatter; the values are
    identical either way."""
    n = first_leaf(batch).shape[0]

    def write(s, b):
        if n == cap:
            s.copy_(torch.roll(b, first, 0))
        else:
            s[pos] = b
        return s

    map_leaves(write, storage, batch)


def push_batch(buf: BufferState, batch) -> BufferState:
    """Write a batch (leading dim n) at rolling positions; n may exceed the
    capacity (the ring keeps the newest entries, as per-step pushes would)."""
    cap = buf.capacity
    batch, pos, first, n = _ring_positions(batch, buf.idx, cap)
    _ring_write(buf.storage, batch, pos, first, cap)
    return BufferState(storage=buf.storage, idx=(buf.idx + n) % cap,
                       size=min(buf.size + n, cap), priorities=buf.priorities)


def push_batch_prioritized(buf: BufferState, batch, eps: float = 0.05,
                           clip: float = 1.0) -> BufferState:
    """``push_batch`` whose records enter at the ring's largest priority,
    floored at ``(1 + eps)·clip``, the largest ``update_priorities`` can
    write (a fixed floor of 1 with ``clip < 1`` would skew sampling toward
    the newest records). A push that replaces the whole ring sets every
    slot."""
    cap = buf.capacity
    batch, pos, first, n = _ring_positions(batch, buf.idx, cap)
    _ring_write(buf.storage, batch, pos, first, cap)
    p_new = torch.clamp(buf.priorities.max(), min=(1.0 + eps) * clip)
    if first_leaf(batch).shape[0] == cap:
        buf.priorities.copy_(p_new.expand(cap))
    else:
        buf.priorities[pos] = p_new
    return BufferState(storage=buf.storage, idx=(buf.idx + n) % cap,
                       size=min(buf.size + n, cap), priorities=buf.priorities)


def sample_slots(buf: BufferState, generator: torch.Generator,
                 batch_size: int) -> torch.Tensor:
    """``[B]`` slots drawn uniformly with replacement over the valid prefix."""
    return torch.randint(0, max(buf.size, 1), (batch_size,), generator=generator,
                         device=first_leaf(buf.storage).device)


def sample_prioritized(buf: BufferState, generator: Optional[torch.Generator],
                       batch_size: int, alpha: float, beta,
                       slots: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Proportional sample: ``P(i) = softmax(α·log p)`` over the slots with
    ``p > 0``. Returns ``(slots, weights)``: ``[B]`` slots drawn with
    replacement by ``torch.multinomial`` from ``generator`` (the reference
    draws ``jax.random.categorical`` on the same logits: the same
    distribution, not the same bits), or the given ``slots``; and the
    importance weights ``(n·P(i))^−β`` normalised to unit MEAN over the
    batch, so the gradient's scale matches uniform replay's (max
    normalisation made the step size hinge on the rarest slot sampled and
    destabilised sokoban in the reference's runs)."""
    p = buf.priorities
    logits = torch.where(p > 0, alpha * torch.log(torch.clamp(p, min=1e-12)),
                         torch.full_like(p, -float("inf")))
    probs = torch.softmax(logits, 0)
    if slots is None:
        slots = torch.multinomial(probs, batch_size, replacement=True, generator=generator)
    n = float(max(buf.size, 1))
    weights = torch.pow(n * probs[slots], -beta)
    return slots, weights / torch.clamp(weights.mean(), min=1e-12)


def update_priorities(buf: BufferState, slots: torch.Tensor, td_errors: torch.Tensor,
                      eps: float = 0.05, clip: float = 1.0) -> BufferState:
    """Write ``max(min(|δ|, clip) + eps·clip, 1e-6)`` at the sampled slots.

    The clip keeps one early large |δ| from pinning the largest priority
    (every push would inherit it and sampling would collapse onto the
    newest records); the floor ``eps·clip`` bounds how much less often a
    mastered record is drawn than a hard one, ``(1 + eps)/eps``; ``1e-6``
    keeps a zero-δ slot sampleable at ``eps = 0`` (the valid mask is
    ``p > 0``). A repeated slot carries the same record and parameters, but
    on the card its |δ| may differ in the last bits from one batch row to
    another (a matrix product need not round every row alike), and a
    plain index write keeps whichever write lands last: the largest is
    written instead, so the ring does not depend on the order of the
    writes (the reference's duplicates write equal values)."""
    p = torch.clamp(torch.clamp(td_errors.abs(), max=clip) + eps * clip, min=1e-6)
    buf.priorities.scatter_reduce_(0, slots.long(), p.to(torch.float32), reduce="amax",
                                   include_self=False)
    return buf


def gather(buf: BufferState, slots: torch.Tensor):
    """The records at ``slots`` (leaves ``[*slots.shape, ...]``)."""
    return map_leaves(lambda s: s[slots], buf.storage)


def sample(buf: BufferState, generator: torch.Generator, batch_size: int):
    """Uniform sample with replacement over the valid prefix."""
    return gather(buf, sample_slots(buf, generator, batch_size))
