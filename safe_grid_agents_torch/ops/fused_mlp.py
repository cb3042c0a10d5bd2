"""Fused actor-critic MLP forward in one CUDA kernel launch, with a
PyTorch backward.

Counterpart of ``safe_grid_agents_tpu/ops/fused_mlp.py`` (kernel B11 of
ROADMAP queue B). ``fused_mlp`` is a ``torch.autograd.Function``: its
forward launches ``csrc/fused_mlp.cu`` for CUDA tensors and runs
``fused_mlp_reference`` (three matmuls and two tanh) for CPU tensors; it
keeps ``h1``, ``h2`` for the backward, which is plain ``torch.matmul``, as
the JAX package leaves its ``_fused_bwd`` to XLA outside any Pallas kernel.

Layout (flax's, ``PallasActorCriticMLP``): ``w1 [Dp, 128]`` with
``Dp = round_up(D, 128)``, ``b1 [1, 128]``, ``w2 [128, 128]``, ``b2``,
``wh [128, 128]``, ``bh [1, 128]``; the packed head's column ``a < A`` is
logit a and column A the value. The reference zero-pads ``x`` to ``Dp``;
the kernel and the plain version read ``x [B, D]`` and the first D rows of
``w1``, which is the same sum.

The kernel computes its products on the tensor cores in 3xTF32 and walks
row tiles of 64, 32 or 16 rows in persistent blocks; ``geometry`` mirrors
its choice. The MXU PPO trainer calls the forward 81 times a chunk, so the
wrapper's launch path counts: one allocation holds ``out``, ``h1`` and
``h2`` (``[3, B, 128]``), ``.contiguous()`` runs only on a tensor that is
not, and the checks cost a few attribute reads each.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch import nn

from ..agents.networks import ActorCriticNet
from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .rollout_kernel import check_tensor

counts = LaunchCounts()

HIDDEN = 128    # both hidden layers
HEAD_PAD = 128  # packed logits + value head


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_mlp_reference(x, w1, b1, w2, b2, wh, bh):
    """Plain PyTorch forward: ``(out, h1, h2)``."""
    counts.plain_calls += 1
    h1 = torch.tanh(x @ w1[: x.shape[1]] + b1)
    h2 = torch.tanh(h1 @ w2 + b2)
    return h2 @ wh + bh, h1, h2


# Row tiles of the kernel, largest first; for each the depth of a w1 k-tile
# and the k-tiles in its ring (``Tile`` in the .cu). Shared-memory strides
# (floats): weight rows, activation rows; x tile rows are the depth + 4.
ROW_TILES = (64, 32, 16)
RING = {64: (16, 4), 32: (32, 3), 16: (32, 4)}
LD_W, LD_H = HIDDEN + 8, HIDDEN + 4


@dataclasses.dataclass(frozen=True)
class Geometry:
    rows: int        # rows of a tile
    tiles: int       # ceil(B / rows)
    grid: int        # persistent blocks: min(tiles, SMs)
    smem_bytes: int  # shared memory of a block


def geometry(B: int, n_sm: int) -> Geometry:
    """The kernel's launch geometry for ``B`` rows on a card of ``n_sm``
    SMs (``row_tile`` and ``fused_mlp_geometry`` in the .cu): the largest
    row tile that still gives more than ``n_sm / 2`` tiles, else the
    smallest, so that a small batch spreads over more SMs and a large one
    streams ``w1`` fewer times."""
    rows = next((r for r in ROW_TILES[:-1] if 2 * -(-B // r) > n_sm), ROW_TILES[-1])
    tiles = -(-B // rows)
    depth, stages = RING[rows]
    floats = (2 * HIDDEN * LD_W + stages * depth * LD_W + stages * rows * (depth + 4)
              + rows * LD_H)
    return Geometry(rows, tiles, min(tiles, n_sm), 4 * floats)


def _lib_handle():
    return build("fused_mlp")["fused_mlp"]


def kernel_geometry(B: int, n_sm: int) -> tuple:
    """``(rows, tiles, grid, smem_bytes)`` as the built kernel computes them;
    needs nvcc, so only on a card host, where it is held against
    ``geometry``."""
    fn = _lib_handle().fused_mlp_geometry
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 4)()
    fn(B, n_sm, ctypes.addressof(out))
    return tuple(int(x) for x in out)


def bind(lib):
    """The typed ``fused_mlp_launch`` of a loaded library."""
    fn = lib.fused_mlp_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I] + [P] * 7 + [P]
    fn.restype = ctypes.c_int
    return fn


_fn = None  # the typed fused_mlp_launch, once built


def _lib():
    global _fn
    if _fn is None:
        _fn = bind(_lib_handle())
    return _fn


def fused_mlp_forward(x, w1, b1, w2, b2, wh, bh):
    """``(out [B, 128], h1 [B, 128], h2 [B, 128])``. CUDA tensors launch the
    kernel (the three outputs are views of one ``[3, B, 128]`` buffer); CPU
    tensors run ``fused_mlp_reference``."""
    if x.dim() != 2:
        raise ValueError(f"x: expected [B, D], got shape {tuple(x.shape)}")
    B, D = x.shape
    dev = x.device
    check_tensor(x, torch.float32, (B, D), dev, "x")
    check_tensor(w1, torch.float32, (round_up(D, 128), HIDDEN), dev, "w1")
    check_tensor(w2, torch.float32, (HIDDEN, HIDDEN), dev, "w2")
    check_tensor(wh, torch.float32, (HIDDEN, HEAD_PAD), dev, "wh")
    for name, t in (("b1", b1), ("b2", b2), ("bh", bh)):
        check_tensor(t, torch.float32, (1, HIDDEN), dev, name)
    if dev.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2, wh, bh)
    if dev.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {dev}")
    fn = _lib()
    buf = torch.empty((3, B, HIDDEN), dtype=torch.float32, device=dev)
    with current_device(dev):
        err = fn(x.data_ptr(), B, D, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), wh.data_ptr(), bh.data_ptr(), buf.data_ptr(), stream_of(dev))
    check(err, "fused_mlp_launch")
    counts.launches += 1
    return buf.unbind(0)


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


class FusedMLP(torch.autograd.Function):
    """``x [B, D]`` → packed head ``[B, 128]``; the backward of
    ``_fused_bwd`` (``safe_grid_agents_tpu/ops/fused_mlp.py:118-139``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, wh, bh):
        out, h1, h2 = fused_mlp_forward(*map(_contiguous, (x, w1, b1, w2, b2, wh, bh)))
        ctx.save_for_backward(x, h1, h2, w1, w2, wh)
        return out

    @staticmethod
    def backward(ctx, g):
        x, h1, h2, w1, w2, wh = ctx.saved_tensors
        D = x.shape[1]
        dwh = h2.T @ g
        dbh = g.sum(0, keepdim=True)
        dz2 = (g @ wh.T) * (1.0 - h2 * h2)
        dw2 = h1.T @ dz2
        db2 = dz2.sum(0, keepdim=True)
        dz1 = (dz2 @ w2.T) * (1.0 - h1 * h1)
        dw1 = torch.zeros_like(w1)
        dw1[:D] = x.T @ dz1
        db1 = dz1.sum(0, keepdim=True)
        dx = dz1 @ w1[:D].T
        return dx, dw1, db1, dw2, db2, dwh, dbh


def fused_mlp(x, w1, b1, w2, b2, wh, bh) -> torch.Tensor:
    return FusedMLP.apply(x, w1, b1, w2, b2, wh, bh)


class PallasActorCriticMLP(ActorCriticNet):
    """The actor-critic ``PPOAgent(net="pallas")`` runs: ``ActorCriticMLP``
    with hidden (128, 128), its forward through ``fused_mlp``."""

    def __init__(self, d_in: int, n_actions: int):
        super().__init__()
        self.n_actions = n_actions
        self.d_in = d_in
        shapes = dict(w1=(round_up(d_in, 128), HIDDEN), b1=(1, HIDDEN),
                      w2=(HIDDEN, HIDDEN), b2=(1, HIDDEN), wh=(HIDDEN, HEAD_PAD),
                      bh=(1, HEAD_PAD))
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def forward(self, obs: torch.Tensor):  # obs [..., P, H, W]
        x = obs.reshape(*obs.shape[:-3], -1).to(torch.float32)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        out = fused_mlp(x, self.w1, self.b1, self.w2, self.b2, self.wh, self.bh)
        logits, value = out[:, : self.n_actions], out[:, self.n_actions]
        if squeeze:
            logits, value = logits[0], value[0]
        return logits, value
