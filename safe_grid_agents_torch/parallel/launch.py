"""Local ranks: run one function on W fresh processes joined to one group.

``spawn(fn, W, args)`` starts W processes with the ``spawn`` start method
(a parent that has imported other frameworks must not fork), joins them to
one process group through a ``FileStore`` in a temporary directory (no
port to collide on), calls ``fn(*args)`` on each and returns what each
returned, in rank order. Each rank runs on one CPU thread, and each
collective waits at most ``multihost.TIMEOUT``. Past ``timeout`` seconds
(default ``JOIN_TIMEOUT``) the parent kills every child and raises
``TimeoutError``; a rank that raises takes the others down and its error
is raised in the parent.

The CLI runs ``--n-devices N --platform cpu`` this way (N gloo ranks of
one host), and ``--n-devices N`` on the card with one NCCL rank per card.
``fn`` must be importable from this package (or any module that imports
no more than the port), because a spawned child imports it afresh.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .multihost import TIMEOUT

# Seconds a spawn may run before its ranks are killed (None: no bound).
JOIN_TIMEOUT: Optional[float] = None


def _entry(rank: int, fn: Callable, world: int, backend: str, tmp: str, args: tuple) -> None:
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@contextlib.contextmanager
def single_rank(backend: str = "gloo"):
    """This process as the one rank of a fresh group (world size 1) while
    the block runs: DP code at W = 1 in-process, NCCL on one card or gloo."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already joined")
    with tempfile.TemporaryDirectory(prefix="sga_rank_") as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1), world_size=1,
            rank=0, timeout=TIMEOUT)
        try:
            yield
        finally:
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), backend: str = "gloo",
          timeout: Optional[float] = None) -> List[Any]:
    """``fn(*args)`` on ``world`` spawned ranks of one ``backend`` group;
    returns each rank's result, pickled by the rank and read back here (a
    rank returns CPU tensors, or its results need a card). ``timeout`` (s)
    bounds the whole run; None reads ``JOIN_TIMEOUT`` at the call."""
    if timeout is None:
        timeout = JOIN_TIMEOUT
    with tempfile.TemporaryDirectory(prefix="sga_ranks_") as tmp:
        ctx = mp.start_processes(_entry, args=(fn, world, backend, tmp, tuple(args)),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=None if deadline is None
                               else max(0.1, deadline - time.monotonic())):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} "
                                       f"did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
