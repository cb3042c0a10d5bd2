"""On-device ring replay buffer (uniform).

Counterpart of the uniform half of ``safe_grid_agents_tpu/utils/replay.py``:
fixed-shape tensors with a modular write index, written in batches and
sampled uniformly with replacement over the valid prefix. A ring holds one
of two records, both compact (observations are rendered at update time):

* ``Transition`` — the fused DQN trainer's compiled-env records (state
  indices and step counts), which kernel B3 writes and B4 reads;
* ``Experience`` — the array engine's transitions, whose states are the
  env's state records (``types.map_leaves`` walks their fields).

The write position and the fill level are host integers:
every push has a size the host knows, so tracking them needs no device
read. Pushes write the storage tensors in place (the JAX ring returns new
arrays); ``BufferState`` is a handle on them.

Prioritized replay (the PER half of the JAX file) is not ported yet
(ROADMAP A.9).
"""
from __future__ import annotations

import dataclasses
from typing import Any

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

    @property
    def capacity(self) -> int:
        return self.storage.action.shape[0]


def init(capacity: int, device) -> BufferState:
    storage = Transition(**{
        k: torch.zeros(capacity, dtype=d, device=device) for k, d in RECORD_DTYPES.items()
    })
    return BufferState(storage=storage, idx=0, size=0)


def init_like(capacity: int, example: Experience) -> BufferState:
    """A ring of ``capacity`` records shaped like ``example``'s first
    record (its leaves ``[n, ...]``), on its device."""
    storage = map_leaves(
        lambda x: torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device), example)
    return BufferState(storage=storage, idx=0, size=0)


def _ring_positions(batch, idx: int, cap: int):
    """(batch', positions, first position, advance): ring-write plan for a
    push of n.

    When n exceeds the capacity the oldest n − cap entries of the push can
    never survive the wrap, so they are dropped and the scatter has distinct
    positions. Record t of the push lands at (idx + t) % cap, exactly as
    per-step pushes would place it."""
    n = batch.action.shape[0]
    dev = batch.action.device
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
                       size=min(buf.size + n, cap))


def sample_slots(buf: BufferState, generator: torch.Generator,
                 batch_size: int) -> torch.Tensor:
    """``[B]`` slots drawn uniformly with replacement over the valid prefix."""
    return torch.randint(0, max(buf.size, 1), (batch_size,), generator=generator,
                         device=buf.storage.action.device)


def gather(buf: BufferState, slots: torch.Tensor):
    """The records at ``slots`` (leaves ``[*slots.shape, ...]``)."""
    return map_leaves(lambda s: s[slots], buf.storage)


def sample(buf: BufferState, generator: torch.Generator, batch_size: int):
    """Uniform sample with replacement over the valid prefix."""
    return gather(buf, sample_slots(buf, generator, batch_size))
