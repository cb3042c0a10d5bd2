"""Fused PPO optimize: every epoch × minibatch update of the table-folded
actor-critic in one C entry point (a fixed sequence of CUDA kernels on one
stream).

Counterpart of ``safe_grid_agents_tpu/ops/ppo_kernel.py`` (kernel B6 of
ROADMAP queue B). ``ppo_optimize`` launches ``csrc/ppo_kernel.cu`` for
CUDA tensors; ``ppo_optimize_reference`` is the plain PyTorch version it is
held against, and the one ``ppo_optimize`` runs for CPU tensors: U steps
of ``PPOAgent.update`` (autograd of the agent's own loss, the global-norm
clip and Adam over the flat params), so the kernel's hand-derived backward
is held against autograd.

The caller applies the tile-shuffled minibatch membership
(``training/ppo_mxu.py``) and passes the epochs-stacked streams ``[U, B]``
(state index, action, old logp, advantage, return); update u reads row u.
The parameters and Adam's moments are flat vectors in the agent's ravel
order; the loss is the mean over the U updates of each update's minibatch
mean. Scope: ``net='table'`` with two hidden layers.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..agents.ppo import PPOAgent
from ..envs.compiled import TableState
from . import LaunchCounts
from ._build import build, check
from .rollout_kernel import check_tensor

counts = LaunchCounts()

STREAM_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.float32)
# Flat-layout names of w1, b1, W2, b2, the logits head (Wl, bl) and the
# value head (Wv, bv), in the order the kernel takes their offsets.
OFFSET_NAMES = ("w1", "b1", "Dense_0.kernel", "Dense_0.bias", "Dense_1.kernel",
                "Dense_1.bias", "Dense_2.kernel", "Dense_2.bias")


@dataclasses.dataclass(frozen=True)
class OptHyper:
    lr: float
    clipping: float
    value_coef: float
    max_norm: float
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    @classmethod
    def from_agent(cls, agent: PPOAgent) -> "OptHyper":
        return cls(float(agent.lr), float(agent.clipping), float(agent.value_coef),
                   float(agent.max_grad_norm))

    def f32(self):
        """``(lr, 1 − c, 1 + c, c_v, max_norm, β1, 1 − β1, β2, 1 − β2, ε)``
        as float32; the differences are taken in double first, as the
        reference takes them."""
        return tuple(float(np.float32(v)) for v in (
            self.lr, 1.0 - self.clipping, 1.0 + self.clipping, self.value_coef,
            self.max_norm, self.beta1, 1.0 - self.beta1, self.beta2,
            1.0 - self.beta2, self.eps))


def flat_offsets(agent: PPOAgent) -> Tuple[int, ...]:
    """Offsets of ``OFFSET_NAMES`` in the agent's flat parameter vector."""
    at, offs = 0, {}
    for k in sorted(agent.shapes):
        offs[k] = at
        at += int(np.prod(agent.shapes[k]))
    return tuple(offs[k] for k in OFFSET_NAMES)


def check_agent(agent: PPOAgent) -> None:
    if agent.net_kind != "table" or len(agent.hidden) != 2:
        raise ValueError(
            f"the fused PPO optimize kernel takes the table-folded net with two hidden "
            f"layers, got net={agent.net_kind!r}, hidden={agent.hidden}")


def ppo_optimize_reference(agent: PPOAgent, flat, mu, nu, count, ce, streams):
    """Plain PyTorch version of the kernel: U autograd steps of the agent's
    loss with the global-norm clip and Adam."""
    counts.plain_calls += 1
    sidx, act, olp, adv, ret = streams
    losses = []
    for u in range(sidx.shape[0]):
        batch = {"states": TableState(idx=sidx[u], t=torch.zeros_like(sidx[u])),
                 "actions": act[u], "old_logp": olp[u], "advantages": adv[u],
                 "returns": ret[u]}
        flat, mu, nu, loss = agent.update(flat, mu, nu, count + u, batch, ce.reshape(()))
        losses.append(loss)
    return flat, mu, nu, count + sidx.shape[0], torch.stack(losses).mean().reshape(1)


def _lib():
    lib = build("ppo_kernel")["ppo_kernel"]
    fn = lib.ppo_optimize_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] + [I] * 5 + [ctypes.POINTER(I), I, P, P, P] + [P] * 5 + [I] * 2
                       + [F] * 10
                       + [P] * 3 + [P])
        fn.restype = ctypes.c_int
        lib.ppo_optimize_scratch.argtypes = [I] * 7
        lib.ppo_optimize_scratch.restype = ctypes.c_longlong
    return fn, lib.ppo_optimize_scratch


def ppo_optimize(agent: PPOAgent, flat, mu, nu, count, ce, streams):
    """U fused PPO updates of ``agent``'s table-folded net.

    ``flat``, ``mu``, ``nu`` are ``[P]`` f32 (ravel order), ``count`` a
    ``(1,)`` int64 Adam step count, ``ce`` a ``(1,)`` f32 entropy
    coefficient and ``streams`` the five ``[U, B]`` minibatch streams.
    Returns ``(flat, mu, nu, count, loss)`` with ``count`` and ``loss`` of
    shape ``(1,)``. CUDA tensors launch the kernel; CPU tensors run
    ``ppo_optimize_reference``."""
    check_agent(agent)
    if len(streams) != 5 or streams[0].dim() != 2:
        raise ValueError("streams: expected five [U, B] tensors")
    U, B = streams[0].shape
    dev = flat.device
    obs = agent.obs_flat
    S, D = obs.shape
    H1, H2 = agent.hidden
    A = agent.env.n_actions
    P = flat.numel()
    check_tensor(obs, torch.float32, (S, D), dev, "obs")
    for name, t in (("flat", flat), ("mu", mu), ("nu", nu)):
        check_tensor(t, torch.float32, (P,), dev, name)
    check_tensor(count, torch.int64, (1,), dev, "count")
    check_tensor(ce, torch.float32, (1,), dev, "ce")
    for name, t, dtype in zip(("sidx", "action", "old_logp", "advantage", "return"),
                              streams, STREAM_DTYPES):
        check_tensor(t, dtype, (U, B), dev, name)
    if dev.type == "cpu":
        return ppo_optimize_reference(agent, flat, mu, nu, count, ce, streams)
    if dev.type != "cuda":
        raise ValueError(f"ppo_optimize: unsupported device {dev}")
    hyper = OptHyper.from_agent(agent)
    fn, scratch_floats = _lib()
    offs = (ctypes.c_int * 8)(*flat_offsets(agent))
    state = torch.cat([flat, mu, nu])
    scratch = torch.empty(int(scratch_floats(S, D, H1, H2, A, P, B)), dtype=torch.float32,
                          device=dev)
    count_o = torch.empty((1,), dtype=torch.int64, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(obs.data_ptr(), S, D, H1, H2, A, offs, P, state.data_ptr(),
                 count.data_ptr(), ce.data_ptr(), *(t.data_ptr() for t in streams), U, B,
                 *hyper.f32(), scratch.data_ptr(), count_o.data_ptr(), loss.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    check(err, "ppo_optimize_launch")
    counts.launches += 1
    return state[:P], state[P:2 * P], state[2 * P:], count_o, loss
