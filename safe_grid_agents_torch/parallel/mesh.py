"""Process grids: the port's counterpart of the reference's device mesh.

Counterpart of ``safe_grid_agents_tpu/parallel/mesh.py``. The reference
lays its devices out as a ``('data', 'model')`` mesh inside one program;
here each device is one process, and each axis of the grid is a
``torch.distributed`` process group with one rank per device (a card over
NCCL, or a CPU process over gloo). ``make_mesh(n_data, n_model)`` lays the
joined group's ranks (``multihost.ensure_initialized`` or ``launch.spawn``)
out as the reference's ``np.array(devices).reshape(n_data, n_model)``: rank
``r`` sits at data index ``r // n_model`` and model index ``r % n_model``.
Its ``data`` sub-group is the ranks that share this rank's model index (env
lanes and replay shard over it; gradients all-reduce over it), its
``model`` sub-group the ranks that share its data index (the dense layers
of ``parallel/tp.py`` shard over it). ``make_1d_mesh`` gives the
single-axis groups of the ``pp``, ``ep`` and ``sp`` demos.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One axis of the grid as this process sees it: the process group of
    the ranks along it, their count and this process's index among them."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    world_size: int
    rank: int                           # this process's index along the axis
    device: torch.device                # where this rank's tensors live
    backend: str                        # "nccl" or "gloo"


@dataclasses.dataclass(frozen=True)
class DataGroup(AxisGroup):
    """The ``data`` axis of one process: env lanes shard over its ranks,
    learner state is replicated on each (or, under ``--tp``, sharded over
    ``model`` and replicated over ``data``)."""

    model: Optional[AxisGroup] = None   # the model axis; None at n_model = 1

    def lanes(self, n: int) -> slice:
        """This rank's slice ``[d·n/D, (d+1)·n/D)`` of ``n`` global lanes,
        ``d`` its data index."""
        if n % self.world_size:
            raise ValueError(f"{n} lanes do not split over {self.world_size} ranks")
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)


def local_rank() -> int:
    """This process's index among the ranks of its host: ``LOCAL_RANK`` as
    the launcher (or ``launch.spawn``) sets it, else the global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _joined(device) -> tuple:
    """``(world, rank, backend, device)`` of the joined (default) group;
    ``device`` defaults to ``cuda:<local rank>`` over NCCL and the CPU over
    gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is joined: call multihost.ensure_initialized() "
                           "under a launcher, or run through launch.spawn")
    backend = str(dist.get_backend())
    if device is None:
        device = torch.device("cuda", local_rank()) if backend == "nccl" else "cpu"
    return dist.get_world_size(), dist.get_rank(), backend, resolve_device(device)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> DataGroup:
    """The ``n_data × n_model`` grid of the joined group's ranks, seen from
    this process. ``n_data`` defaults to the world size over ``n_model``.
    Every process calls it (``dist.new_group`` is collective: every rank
    creates every sub-group, in the same order). With ``n_model = 1`` the
    data axis is the default group itself."""
    world, rank, backend, device = _joined(device)
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh of {n_data} data x {n_model} model ranks != the "
                         f"{world} ranks of the group")
    if n_model == 1:
        return DataGroup(None, world, rank, device, backend)
    data_groups = [dist.new_group(list(range(m, world, n_model))) for m in range(n_model)]
    model_groups = [dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
                    for d in range(n_data)]
    d, m = divmod(rank, n_model)
    return DataGroup(data_groups[m], n_data, d, device, backend,
                     AxisGroup(model_groups[d], n_model, m, device, backend))


def make_1d_mesh(axis_name: str, n: int, device=None) -> Optional[AxisGroup]:
    """A single-axis group over the first ``n`` ranks of the joined group
    (the ``stage``, ``expert`` and ``seq`` axes of the ``pp``, ``ep`` and
    ``sp`` demos); every process calls it, and one outside the first ``n``
    gets None."""
    world, rank, backend, device = _joined(device)
    if world < n:
        raise ValueError(f"{world} ranks < {n} for '{axis_name}'")
    group = None if n == world else dist.new_group(list(range(n)))
    return AxisGroup(group, n, rank, device, backend) if rank < n else None
