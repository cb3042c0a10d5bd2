"""Data groups: the port's counterpart of the reference's device mesh.

Counterpart of ``safe_grid_agents_tpu/parallel/mesh.py``. The reference
lays its devices out as a ``('data', 'model')`` mesh inside one program;
here each device is one process, and the ``data`` axis is a
``torch.distributed`` process group with one rank per device (a card over
NCCL, or a CPU process over gloo). ``make_mesh`` describes the group a
process has joined (``multihost.ensure_initialized`` or
``launch.spawn``): its ranks, this rank, and the device this rank computes
on. The ``model`` axis (tensor parallelism, ``--tp``) is not ported
(ROADMAP A.14b).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The ``data`` axis of one process: env lanes shard over its ranks,
    learner state is replicated on each."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    world_size: int
    rank: int
    device: torch.device                # where this rank's tensors live
    backend: str                        # "nccl" or "gloo"

    def lanes(self, n: int) -> slice:
        """This rank's slice ``[r·n/W, (r+1)·n/W)`` of ``n`` global lanes."""
        if n % self.world_size:
            raise ValueError(f"{n} lanes do not split over {self.world_size} ranks")
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)


def local_rank() -> int:
    """This process's index among the ranks of its host: ``LOCAL_RANK`` as
    the launcher (or ``launch.spawn``) sets it, else the global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> DataGroup:
    """The ``DataGroup`` of the joined (default) process group. ``n_data``
    must be its world size when given;
    ``device`` defaults to ``cuda:<local rank>`` over NCCL and the CPU over
    gloo."""
    if n_model != 1:
        raise ValueError(f"n_model={n_model}: the model axis (--tp) is not ported "
                         "(ROADMAP A.14b)")
    if not dist.is_initialized():
        raise RuntimeError("no process group is joined: call multihost.ensure_initialized() "
                           "under a launcher, or run through launch.spawn")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is not None and n_data != world:
        raise ValueError(f"mesh of {n_data} data ranks != the group's {world} ranks")
    backend = str(dist.get_backend())
    if device is None:
        device = torch.device("cuda", local_rank()) if backend == "nccl" else "cpu"
    return DataGroup(None, world, rank, resolve_device(device), backend)
