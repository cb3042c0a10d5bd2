"""Checkpoint / resume on ``torch.save``.

Counterpart of ``safe_grid_agents_tpu/utils/checkpoint.py`` (orbax there).
A run's whole state is one tree, ``(astate, vstate, generator)``: the
port's record dataclasses (tensors, Python ints such as the replay ring's
write position and fill level, ``None`` where a uniform ring keeps no
priorities), dicts of params, tuples, and the run's ``torch.Generator``
(the reference's key). A run restored from a step continues bit for bit as
the run that wrote it would have.

Layout: one file a step, ``<dir>/<step>/state.pt``. It holds a dict of
plain values (``torch.load(..., weights_only=True)`` reads it; no class is
pickled): ``{"step": step, "leaves": [(path, kind, value), ...]}``, each
leaf's path a tuple of field names, dict keys and tuple indices, its kind
``"tensor"`` (a CPU tensor), ``"generator"`` (the generator's
``get_state()``; a CUDA generator's is a CPU byte tensor of its seed and
offset) or ``"value"`` (an int, float, bool, str or ``None``). A write goes
to a temporary name in the step's directory, is flushed and fsynced, and is
then renamed to ``state.pt``: a process killed mid-write leaves no file
that ``latest_step`` or ``restore_latest_valid`` reads as a step.

Under several ranks (the CLI's ``--n-devices N``, with or without
``--tp``) each rank owns a lane shard, a replay ring of ``capacity / D``,
its generator and, under ``--tp``, its parameter shards, so each writes its
whole local tree, ``<dir>/<step>/rank-<r>.pt``, with the same temporary
name, fsync and rename. The step is committed by one marker,
``<dir>/<step>/ranks.json`` (``{"step", "world", "tp"}``), which rank 0
writes after a barrier that follows every rank's rename; a save returns
after a second barrier, once the step is committed, so such a save is
synchronous. A step counts only with its marker and all of its rank files
(a torn step is not taken), and the ranks restore the newest step that
every one of them reads.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

FILE = "state.pt"
MARKER = "ranks.json"
SCALARS = (int, float, bool, str, type(None))

_EXECUTOR: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PENDING: Dict[str, List[concurrent.futures.Future]] = {}
_LOCK = threading.Lock()


def leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` of every leaf of ``tree`` in a fixed order: fields of
    dataclasses in declaration order, dicts in key order, tuples and lists
    by index. Leaves are tensors, generators and plain scalars."""
    if isinstance(tree, (torch.Tensor, torch.Generator, SCALARS)):
        yield prefix, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), prefix + (f.name,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"{'/'.join(prefix)}: dict key {k!r} is not a str")
            yield from leaves(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    else:
        raise TypeError(f"{'/'.join(prefix) or '<root>'}: cannot checkpoint a "
                        f"{type(tree).__name__}")


def _snapshot(state: Any) -> List[Tuple[Tuple[str, ...], str, Any]]:
    """The leaves as CPU copies: later in-place writes to the live tensors
    (the replay ring, PER's priorities) do not reach a pending write."""
    out = []
    for path, x in leaves(state):
        if isinstance(x, torch.Tensor):
            out.append((path, "tensor", x.detach().to("cpu", copy=True)))
        elif isinstance(x, torch.Generator):
            out.append((path, "generator", x.get_state()))
        else:
            out.append((path, "value", x))
    return out


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, str(int(step)))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a run of several ranks lays its checkpoint out: this process's
    global ``rank`` of ``world``, the run's ``--tp``, and the ``device`` its
    collectives use."""

    rank: int
    world: int
    tp: int
    device: torch.device

    def meta(self) -> Dict[str, int]:
        return {"world": self.world, "tp": self.tp}


def rank_file(rank: int) -> str:
    return f"rank-{int(rank)}.pt"


def step_layout(path: str, step: int) -> Optional[Dict[str, int]]:
    """``{"world", "tp"}`` of a committed step: ``{"world": 1, "tp": 1}``
    for one ``state.pt``, the marker's for rank files; None where the step
    is not committed (no file, no marker, or a rank file missing)."""
    d = _step_dir(path, step)
    if os.path.isfile(os.path.join(d, FILE)):
        return {"world": 1, "tp": 1}
    try:
        with open(os.path.join(d, MARKER)) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    if not all(os.path.isfile(os.path.join(d, rank_file(r))) for r in range(meta["world"])):
        return None
    return {"world": int(meta["world"]), "tp": int(meta["tp"])}


def committed_steps(path: str) -> List[int]:
    """Steps under ``path`` that were committed, in ascending order: one
    ``state.pt``, or a marker with every rank's file."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path)
                  if d.isdigit() and step_layout(path, int(d)) is not None)


def _write_file(d: str, name: str, write) -> None:
    """``write(f)`` to a temporary name in ``d``, flushed and fsynced, then
    renamed to ``name``."""
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{name}.{os.getpid()}.{threading.get_ident()}.tmp")
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(d, name))
    _fsync_dir(d)


def _prune(path: str, max_to_keep: int) -> None:
    """Only committed steps count, and the oldest go only once a newer one
    is committed."""
    for old in committed_steps(path)[:-max_to_keep] if max_to_keep > 0 else []:
        shutil.rmtree(_step_dir(path, old), ignore_errors=True)


def _write(path: str, step: int, snapshot, max_to_keep: int) -> None:
    _write_file(_step_dir(path, step), FILE,
                lambda f: torch.save({"step": int(step), "leaves": snapshot}, f))
    _fsync_dir(path)
    _prune(path, max_to_keep)


def _save_ranks(path: str, step: int, snapshot, layout: Layout, max_to_keep: int) -> None:
    """This rank's file, a barrier, rank 0's marker (and pruning), a barrier."""
    d = _step_dir(path, step)
    _write_file(d, rank_file(layout.rank),
                lambda f: torch.save({"step": int(step), "leaves": snapshot}, f))
    dist.barrier()
    if layout.rank == 0:
        meta = json.dumps({"step": int(step), **layout.meta()}).encode()
        _write_file(d, MARKER, lambda f: f.write(meta))
        _fsync_dir(path)
        _prune(path, max_to_keep)
    dist.barrier()


def _executor() -> concurrent.futures.ThreadPoolExecutor:
    """One writer thread: saves commit in the order they were made."""
    global _EXECUTOR
    with _LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint")
        return _EXECUTOR


def _wait(path: str) -> None:
    with _LOCK:
        futures = _PENDING.pop(path, [])
    for fut in futures:
        fut.result()  # re-raises a failed write


def save(path: str, step: int, state: Any, max_to_keep: int = 3, wait: bool = True,
         layout: Optional[Layout] = None) -> None:
    """Save the run's state tree at ``step``.

    ``wait=False`` returns once the state is snapshotted (copied to the
    host) and writes it in a background thread; ``wait_all`` or the next
    ``save``/``restore`` on the same path with ``wait=True`` waits for it.
    Keeps the ``max_to_keep`` newest committed steps. Under ``layout``
    (several ranks, every one of which calls it) the rank's file is written
    and the step committed before it returns, whatever ``wait``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if layout is not None:
        _save_ranks(path, int(step), _snapshot(state), layout, max_to_keep)
        return
    fut = _executor().submit(_write, path, int(step), _snapshot(state), max_to_keep)
    with _LOCK:
        _PENDING.setdefault(path, []).append(fut)
    if wait:
        _wait(path)


def wait_all() -> None:
    """Wait for every pending save (the end of training, interpreter exit);
    re-raises the first failed write."""
    for path in list(_PENDING):
        _wait(path)


def close_all() -> None:
    global _EXECUTOR
    wait_all()
    with _LOCK:
        ex, _EXECUTOR = _EXECUTOR, None
    if ex is not None:
        ex.shutdown(wait=True)


atexit.register(close_all)


def latest_step(path: str) -> Optional[int]:
    path = os.path.abspath(path)
    _wait(path)
    steps = committed_steps(path)
    return steps[-1] if steps else None


def read(path: str, step: int, rank: Optional[int] = None) -> Dict[str, Any]:
    """The raw leaves of ``step`` (of rank ``rank``'s file where the run had
    several ranks) as ``{"a/b/c": value}`` (no example structure needed):
    tensors on the CPU, a generator as its state."""
    path = os.path.abspath(path)
    _wait(path)
    name = FILE if rank is None else rank_file(rank)
    blob = torch.load(os.path.join(_step_dir(path, step), name), map_location="cpu",
                      weights_only=True)
    return {"/".join(p): v for p, _, v in blob["leaves"]}


def _load(fname: str, example_state: Any) -> Any:
    blob = torch.load(fname, map_location="cpu", weights_only=True)
    saved = {tuple(p): (kind, v) for p, kind, v in blob["leaves"]}
    want = list(leaves(example_state))
    missing = [p for p, _ in want if p not in saved]
    extra = set(saved) - {p for p, _ in want}
    if missing or extra:
        raise ValueError(f"checkpoint structure differs: missing "
                         f"{['/'.join(p) for p in missing][:5]}, extra "
                         f"{['/'.join(p) for p in sorted(extra)][:5]}")
    # Check every leaf before anything is restored (a generator is set in
    # place).
    for p, x in want:
        kind, v = saved[p]
        where = "/".join(p)
        if isinstance(x, torch.Tensor):
            if kind != "tensor" or tuple(v.shape) != tuple(x.shape):
                raise ValueError(f"{where}: saved {kind} {getattr(v, 'shape', v)!r}, "
                                 f"expected a tensor of shape {tuple(x.shape)}")
        elif isinstance(x, torch.Generator):
            if kind != "generator":
                raise ValueError(f"{where}: saved {kind}, expected a generator")
        elif kind != "value" or (x is None) != (v is None):
            raise ValueError(f"{where}: saved {kind} {v!r}, expected {x!r}")
    return _rebuild(example_state, (), saved)


def _rebuild(x: Any, path: Tuple[str, ...], saved) -> Any:
    if isinstance(x, torch.Tensor):
        return saved[path][1].to(device=x.device, dtype=x.dtype, copy=True)
    if isinstance(x, torch.Generator):
        x.set_state(saved[path][1])
        return x
    if isinstance(x, SCALARS):
        return saved[path][1]
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _rebuild(getattr(x, f.name), path + (f.name,), saved)
            for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _rebuild(v, path + (k,), saved) for k, v in x.items()}
    return type(x)(_rebuild(v, path + (str(i),), saved) for i, v in enumerate(x))


def restore(path: str, example_state: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure, dtypes and devices of ``example_state``;
    its generators are set to the saved states in place. A structure or
    shape mismatch raises ``ValueError``."""
    path = os.path.abspath(path)
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    _wait(path)
    return _load(os.path.join(_step_dir(path, step), FILE), example_state)


def restore_latest_valid(path: str, example_state: Any, layout: Optional[Layout] = None):
    """Failure-tolerant restore: try the committed steps newest first,
    skipping any that fail to load (a file torn on disk, another layout).
    Returns ``(step, state)``, or ``(None, None)`` when nothing usable
    exists. Under ``layout`` each rank reads its own file, and a step is
    taken only where every rank read its file (the ranks agree on each
    candidate through an all-reduce), so all resume from one step."""
    path = os.path.abspath(path)
    _wait(path)
    name = FILE if layout is None else rank_file(layout.rank)
    for step in reversed(committed_steps(path)):
        try:
            state, err = _load(os.path.join(_step_dir(path, step), name), example_state), None
        except Exception as e:  # a torn or foreign file: fall back one step
            state, err = None, e
        if layout is not None:
            ok = torch.tensor(int(err is None), device=layout.device)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            if not bool(ok) and err is None:
                err = RuntimeError("another rank could not read its file")
        if err is None:
            return step, state
        print(f"checkpoint step {step} unreadable ({type(err).__name__}); "
              f"falling back", flush=True)
    return None, None
