"""The collectives of the ``data`` axis: the reference's ``psum`` and
``pmean`` over ``axis_name``, as all-reduces over a ``DataGroup``.

Every function takes a ``DataGroup`` and returns new tensors; its inputs
are left as they are. A mean is the all-reduced SUM divided by the world
size, as ``jax.lax.pmean`` is. ``psum_flat`` reduces several tensors of
one dtype in ONE all-reduce (a raveled gradient and its loss, a TD table
and its counts), so that an update pays one collective, not one per
parameter. NCCL takes no bool; callers reduce integers as int64.

Gloo all-reduces CUDA tensors as they are, so a group of gloo ranks can
share one card (``chip_smoke.py`` phase 9b); it gathers none, so
``all_gather_lanes`` gathers host copies there.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import DataGroup


def _all_reduce_(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Sum ``x`` (contiguous, owned by the caller) over the group, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group.group)
    return x


def psum(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Σ over the group's ranks of ``x``."""
    return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), group)


def psum_flat(xs: Sequence[torch.Tensor], group: DataGroup) -> List[torch.Tensor]:
    """Σ over the ranks of each of ``xs`` (one dtype), in one all-reduce of
    their concatenation; returns tensors of the inputs' shapes."""
    flat = _all_reduce_(torch.cat([x.detach().reshape(-1) for x in xs]), group)
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return out


def pmean_flat(xs: Sequence[torch.Tensor], group: DataGroup) -> List[torch.Tensor]:
    """``psum_flat`` divided by the world size."""
    return [x / group.world_size for x in psum_flat(xs, group)]


def all_gather_lanes(x: torch.Tensor, group: DataGroup, dim: int = -1) -> torch.Tensor:
    """The ranks' shards of ``x`` (equal shapes) concatenated along ``dim``
    in rank order: a lane-sharded tensor made whole."""
    x = x.contiguous()
    if group.backend == "gloo" and x.is_cuda:
        parts = [torch.empty_like(x, device="cpu") for _ in range(group.world_size)]
        dist.all_gather(parts, x.cpu(), group=group.group)
        return torch.cat(parts, dim).to(x.device)
    parts = [torch.empty_like(x) for _ in range(group.world_size)]
    dist.all_gather(parts, x, group=group.group)
    return torch.cat(parts, dim)
