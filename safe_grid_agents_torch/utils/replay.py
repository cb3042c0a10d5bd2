"""On-device ring replay buffer (uniform).

Counterpart of the uniform half of ``safe_grid_agents_tpu/utils/replay.py``:
fixed-shape tensors with a modular write index, written in batches and
sampled uniformly with replacement over the valid prefix. The ring stores
compact compiled-env records (state indices and step counts, not rendered
observations). The write position and the fill level are host integers:
every push has a size the host knows, so tracking them needs no device
read. Pushes write the storage tensors in place (the JAX ring returns new
arrays); ``BufferState`` is a handle on them.

Prioritized replay (the PER half of the JAX file) is not ported yet
(ROADMAP A.9).
"""
from __future__ import annotations

import dataclasses

import torch

from ..types import map_fields


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


RECORD_DTYPES = dict(s_idx=torch.int32, s_t=torch.int32, action=torch.int32,
                     reward=torch.float32, n_idx=torch.int32, n_t=torch.int32,
                     done=torch.bool)


@dataclasses.dataclass
class BufferState:
    storage: Transition  # leaves [capacity]
    idx: int             # next write position
    size: int            # valid entries (≤ capacity)

    @property
    def capacity(self) -> int:
        return self.storage.action.shape[0]


def init(capacity: int, device) -> BufferState:
    storage = Transition(**{
        k: torch.zeros(capacity, dtype=d, device=device) for k, d in RECORD_DTYPES.items()
    })
    return BufferState(storage=storage, idx=0, size=0)


def _ring_positions(batch: Transition, idx: int, cap: int):
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
        batch = map_fields(lambda b: b[skip:], batch)
    else:
        skip = 0
    first = (idx + skip) % cap
    pos = (first + torch.arange(min(n, cap), device=dev)) % cap
    return batch, pos, first, n


def _ring_write(storage: Transition, batch: Transition, pos: torch.Tensor,
                first: int, cap: int) -> None:
    """Write ``batch`` at ``pos`` (``first`` = ``pos[0]``, known on the host).
    A batch that replaces the ENTIRE ring is a roll (``storage[j] =
    batch[(j − first) % cap]``) instead of a scatter; the values are
    identical either way."""
    n = batch.action.shape[0]
    for f in dataclasses.fields(Transition):
        s, b = getattr(storage, f.name), getattr(batch, f.name)
        if n == cap:
            s.copy_(torch.roll(b, first, 0))
        else:
            s[pos] = b


def push_batch(buf: BufferState, batch: Transition) -> BufferState:
    """Write a batch (leading dim n) at rolling positions; n may exceed the
    capacity (the ring keeps the newest entries, as per-step pushes would)."""
    cap = buf.capacity
    batch, pos, first, n = _ring_positions(batch, buf.idx, cap)
    _ring_write(buf.storage, batch, pos, first, cap)
    return BufferState(storage=buf.storage, idx=(buf.idx + n) % cap,
                       size=min(buf.size + n, cap))


def sample(buf: BufferState, generator: torch.Generator, batch_size: int) -> Transition:
    """Uniform sample with replacement over the valid prefix."""
    idxs = torch.randint(0, max(buf.size, 1), (batch_size,), generator=generator,
                         device=buf.storage.action.device)
    return map_fields(lambda s: s[idxs], buf.storage)
