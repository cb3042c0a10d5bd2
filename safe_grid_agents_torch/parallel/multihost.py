"""Multi-process runtime: join a process group when a launcher asked for one.

Counterpart of ``safe_grid_agents_tpu/parallel/multihost.py``. The
reference joins ``jax.distributed`` from ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``; the port reads the variables
``torchrun`` sets: ``MASTER_ADDR`` and ``MASTER_PORT`` (the rendezvous),
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``. One process per device, on
each host:

    torchrun --nnodes H --nproc-per-node C --rdzv-endpoint <host:port> \\
        -m safe_grid_agents_torch <env> <agent> --n-devices <H·C> ...

or any launcher that sets those variables. Without them
``ensure_initialized`` does nothing, so the same CLI runs one process or
many. The backend is NCCL for the card and gloo for the CPU; every
collective waits at most ``timeout``.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
TIMEOUT = datetime.timedelta(minutes=30)


def launcher_present() -> bool:
    """True where a launcher set all of ``LAUNCHER_VARS``."""
    return all(os.environ.get(k) for k in LAUNCHER_VARS)


def backend_for(platform: str) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "gloo" if platform == "cpu" else "nccl"


def ensure_initialized(platform: str = "cuda", timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the launcher's process group (``env://``) if the launcher's
    variables are set and no group is joined yet; returns whether a group
    is joined. On the card, this process's device becomes ``cuda:<LOCAL_RANK>``."""
    if dist.is_initialized():
        return True
    if not launcher_present():
        return False  # a single-process run
    backend = backend_for(platform)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return True


def is_primary() -> bool:
    """True on the process that logs, prints and writes files (rank 0, or
    the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
