"""Sequence parallelism over a ``seq`` axis: the ring-attention demo.

Counterpart of ``safe_grid_agents_tpu/parallel/sp.py``. No net of the
reference attends; like the reference, this module shows the runtime can:
ring attention (Liu et al. 2023). The sequence shards over the ranks; each
keeps its query block and the key/value blocks travel the ring
(``collectives.ring_shift``, one hop a step, keys and values in one
message) while the attention accumulates in the streaming online-softmax
form, so no rank forms the ``[L, L]`` score matrix or holds the whole
sequence's keys and values. Autograd runs the reverse ring (the shift's
backward is the inverse shift). It is held to full softmax attention.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .collectives import ring_shift
from .mesh import AxisGroup, make_1d_mesh

SEQ_AXIS = "seq"


def make_sp_mesh(n_shards: int, device=None) -> AxisGroup:
    return make_1d_mesh(SEQ_AXIS, n_shards, device)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Ground truth: softmax attention over the whole sequence; ``[L, d]``
    each → ``[L, d]``."""
    scores = (q @ k.T) / math.sqrt(q.shape[-1])
    return torch.softmax(scores, dim=-1) @ v


def ring_attention(group: AxisGroup, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Ring attention over the ``seq`` group on this rank's blocks ``q``,
    ``k``, ``v`` ``[L/S, d]`` (``place_sp``); returns this rank's block of
    the output, ``[L/S, d]``. Each hop takes one ``[L/S, L/S]`` score block
    of the local queries against the visiting keys into the running max
    ``m``, normaliser ``l`` and output ``o``, then passes the keys and
    values one place round the ring. Every rank of the group calls it."""
    S, d = group.world_size, q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    kv = torch.cat([k, v], -1)
    m = torch.full(q.shape[:1], -math.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros(q.shape[:1], dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    for hop in range(S):
        k_blk, v_blk = kv[:, :d], kv[:, d:]
        s = (q @ k_blk.T) * scale                       # [L/S, L/S]
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l = l * corr + p.sum(-1)
        o = o * corr[:, None] + p @ v_blk
        m = m_new
        if hop < S - 1:  # the last block needs no further hop
            kv = ring_shift(kv, group)
    return o / l[:, None]


def place_sp(group: AxisGroup, *arrays: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This rank's sequence block of each ``[L, d]`` array, on its device."""
    S, r = group.world_size, group.rank
    out = []
    for a in arrays:
        n = a.shape[0] // S
        out.append(a[r * n:(r + 1) * n].to(group.device, copy=True))
    return tuple(out)
