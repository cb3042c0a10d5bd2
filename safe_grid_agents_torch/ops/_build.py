"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled by nvcc for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``
inside the package. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt and a stale
library is never loaded. ``build`` starts one
nvcc per missing library, all at once, then waits for them.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (the ``-Xptxas -v`` register and shared-memory
# report) and wall seconds, for the builds this process ran.
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared device code
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, ctypes.CDLL]:
    """Load the named kernel libraries, compiling the missing ones in
    parallel. Raises ``RuntimeError`` with nvcc's output if a build fails."""
    todo = [n for n in names if n not in _libs and not _target(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            so = _target(n)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, so)
        for n, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            build_logs[n] = out
            build_seconds[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{n}.cu:\n{out}")
            os.replace(tmp, so)
    for n in names:
        if n not in _libs:
            _libs[n] = ctypes.CDLL(str(_target(n)))
    return {n: _libs[n] for n in names}


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(dev: torch.device) -> int:
    """The raw handle of the current stream on CUDA device ``dev``, for a
    kernel's launch, in one call (``torch.cuda.current_stream`` builds a
    ``Stream`` object first; torch's own compiler takes the same call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def current_device(dev: torch.device):
    """A context that makes CUDA device ``dev`` current for a launch; none
    where it already is (entering ``torch.cuda.device`` is part of every
    launch path that takes it)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
