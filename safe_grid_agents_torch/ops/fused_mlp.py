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
"""
from __future__ import annotations

import ctypes

import torch
from torch import nn

from ..agents.networks import ActorCriticNet
from . import LaunchCounts
from ._build import build, check
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


def _lib():
    lib = build("fused_mlp")["fused_mlp"]
    fn = lib.fused_mlp_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I] + [P] * 9 + [P]
        fn.restype = ctypes.c_int
    return fn


def fused_mlp_forward(x, w1, b1, w2, b2, wh, bh):
    """``(out [B, 128], h1 [B, 128], h2 [B, 128])``. CUDA tensors launch the
    kernel; CPU tensors run ``fused_mlp_reference``."""
    if x.dim() != 2:
        raise ValueError(f"x: expected [B, D], got shape {tuple(x.shape)}")
    B, D = x.shape
    dev = x.device
    Dp = round_up(D, 128)
    check_tensor(x, torch.float32, (B, D), dev, "x")
    for name, t, shape in (("w1", w1, (Dp, HIDDEN)), ("b1", b1, (1, HIDDEN)),
                           ("w2", w2, (HIDDEN, HIDDEN)), ("b2", b2, (1, HIDDEN)),
                           ("wh", wh, (HIDDEN, HEAD_PAD)), ("bh", bh, (1, HEAD_PAD))):
        check_tensor(t, torch.float32, shape, dev, name)
    if dev.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2, wh, bh)
    if dev.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {dev}")
    fn = _lib()
    out, h1, h2 = (torch.empty((B, HIDDEN), dtype=torch.float32, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), B, D, *(t.data_ptr() for t in (w1, b1, w2, b2, wh, bh)),
                 out.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    check(err, "fused_mlp_launch")
    counts.launches += 1
    return out, h1, h2


class FusedMLP(torch.autograd.Function):
    """``x [B, D]`` → packed head ``[B, 128]``; the backward of
    ``_fused_bwd`` (``safe_grid_agents_tpu/ops/fused_mlp.py:118-139``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, wh, bh):
        out, h1, h2 = fused_mlp_forward(x.contiguous(), w1.contiguous(), b1.contiguous(),
                                        w2.contiguous(), b2.contiguous(), wh.contiguous(),
                                        bh.contiguous())
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
