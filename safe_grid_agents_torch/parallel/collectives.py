"""The collectives of the grid's axes: the reference's ``psum`` and
``pmean`` over ``axis_name`` as all-reduces over an ``AxisGroup`` (a
``DataGroup`` or its ``model`` axis), Megatron's operators of the model
axis, and the differentiable exchanges of the ``pp``, ``ep`` and ``sp``
demos.

Every function takes an ``AxisGroup`` and returns new tensors; its inputs
are left as they are. A mean is the all-reduced SUM divided by the world
size, as ``jax.lax.pmean`` is. ``psum_flat`` reduces several tensors of
one dtype in ONE all-reduce (a raveled gradient and its loss, a TD table
and its counts), so that an update pays one collective, not one per
parameter. NCCL takes no bool; callers reduce integers as int64.

The model axis (``parallel/tp.py``) runs on three ``torch.autograd``
operators: ``copy_to_model`` (identity forward, all-reduce of the gradient
backward) and ``reduce_from_model`` (all-reduce forward, identity backward)
around a column- and a row-parallel layer, and ``gather_from_model`` where
a column-parallel layer's output meets a replicated layer. ``ring_shift``
is the reference's ``ppermute`` by one place around the ring (its backward
the inverse shift, as ppermute's transpose is), ``all_to_all`` its
``all_to_all`` over the leading axis (its own transpose).

Gloo all-reduces CUDA tensors as they are, so a group of gloo ranks can
share one card (``chip_smoke.py`` phases 9b and 10); it gathers, sends and
exchanges none, so ``all_gather_lanes``, ``ring_shift`` and ``all_to_all``
move host copies there, explicitly.

Every psum and pmean goes through ``_all_reduce_``, which counts its calls
and bytes in ``all_reduce_counts`` (reset and read like a kernel's launch
counts): ``tools/scale.py`` holds the counted bytes of a chunk against the
analytic per-chunk payload.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import AxisGroup


@dataclasses.dataclass
class AllReduceCounts:
    calls: int = 0   # all-reduces issued by this process
    bytes: int = 0   # their payload: the reduced tensor's bytes, one rank's

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0


all_reduce_counts = AllReduceCounts()


def _all_reduce_(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Sum ``x`` (contiguous, owned by the caller) over the group, in place."""
    all_reduce_counts.calls += 1
    all_reduce_counts.bytes += x.numel() * x.element_size()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group.group)
    return x


def psum(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Σ over the group's ranks of ``x``."""
    return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), group)


def psum_flat(xs: Sequence[torch.Tensor], group: AxisGroup) -> List[torch.Tensor]:
    """Σ over the ranks of each of ``xs`` (one dtype), in one all-reduce of
    their concatenation; returns tensors of the inputs' shapes."""
    flat = _all_reduce_(torch.cat([x.detach().reshape(-1) for x in xs]), group)
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return out


def pmean_flat(xs: Sequence[torch.Tensor], group: AxisGroup) -> List[torch.Tensor]:
    """``psum_flat`` divided by the world size."""
    return [x / group.world_size for x in psum_flat(xs, group)]


def _host_staged(group: AxisGroup, x: torch.Tensor) -> bool:
    """Whether an exchange of ``x`` goes through a host copy (gloo, CUDA)."""
    return group.backend == "gloo" and x.is_cuda


def all_gather_lanes(x: torch.Tensor, group: AxisGroup, dim: int = -1) -> torch.Tensor:
    """The ranks' shards of ``x`` (equal shapes) concatenated along ``dim``
    in rank order: a lane-sharded tensor made whole."""
    x = x.contiguous()
    if _host_staged(group, x):
        parts = [torch.empty_like(x, device="cpu") for _ in range(group.world_size)]
        dist.all_gather(parts, x.cpu(), group=group.group)
        return torch.cat(parts, dim).to(x.device)
    parts = [torch.empty_like(x) for _ in range(group.world_size)]
    dist.all_gather(parts, x, group=group.group)
    return torch.cat(parts, dim)


def _own_slice(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """This rank's ``1/W`` of ``x``'s last axis."""
    k = x.shape[-1] // group.world_size
    return x.narrow(-1, group.rank * k, k).contiguous()


# ---- the model axis -----------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_lanes(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group), None


def copy_to_model(x: torch.Tensor, model: AxisGroup) -> torch.Tensor:
    """The replicated input of a column-parallel layer: ``x`` forward, the
    gradient summed over ``model`` backward (each rank holds the part that
    flows through its columns)."""
    return _CopyToModel.apply(x, model)


def reduce_from_model(x: torch.Tensor, model: AxisGroup) -> torch.Tensor:
    """The output of a row-parallel layer: its ranks' partial products
    summed over ``model`` forward, the (replicated) gradient as it is
    backward."""
    return _ReduceFromModel.apply(x, model)


def gather_from_model(x: torch.Tensor, model: AxisGroup) -> torch.Tensor:
    """A last-axis-sharded activation made whole for a replicated layer;
    backward keeps this rank's slice of the (replicated) gradient."""
    return _GatherFromModel.apply(x, model)


# ---- the demos' exchanges ----------------------------------------------------------------

def _peer(group: AxisGroup, i: int) -> int:
    """The global rank of index ``i`` along ``group``."""
    return i if group.group is None else dist.get_global_rank(group.group, i)


def _shift(x: torch.Tensor, group: AxisGroup, step: int) -> torch.Tensor:
    """``x`` sent to index ``i + step`` and received from ``i − step`` (mod W)."""
    W = group.world_size
    if W == 1:
        return x.clone()
    staged = _host_staged(group, x)
    send = (x.cpu() if staged else x).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(group, (group.rank + step) % W), group.group),
           dist.P2POp(dist.irecv, recv, _peer(group, (group.rank - step) % W), group.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if staged else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -1), None


def ring_shift(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``ppermute`` over ``[(i, (i + 1) % W)]``: this rank's ``x`` goes to
    the next rank and the previous rank's arrives; backward shifts the
    gradient the other way. Every rank of the group calls it."""
    return _RingShift.apply(x, group)


def _exchange(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    staged = _host_staged(group, x)
    send = (x.cpu() if staged else x).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group.group)
    return recv.to(x.device) if staged else recv


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``all_to_all(split_axis=0, concat_axis=0, tiled=False)`` of ``x``
    ``[W, ...]``: row ``j`` of rank ``k`` becomes row ``k`` of rank ``j``.
    The exchange is its own transpose, so backward exchanges the gradient
    the same way."""
    if x.shape[0] != group.world_size:
        raise ValueError(f"all_to_all over {group.world_size} ranks takes [W, ...], "
                         f"got {tuple(x.shape)}")
    return _AllToAll.apply(x, group)
