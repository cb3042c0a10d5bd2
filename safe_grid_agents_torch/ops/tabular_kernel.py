"""Fused tabular-Q training: act → env step → TD learn for T steps in one
CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/tabular_kernel.py`` (kernel B2 of
ROADMAP queue B). ``tabq`` launches ``csrc/tabular_kernel.cu`` for CUDA
tensors; ``tabq_reference`` is the plain PyTorch version it is held against,
and the one ``tabq`` runs for CPU tensors.

Per step and lane: ε-greedy on presampled draws (``explore = u < ε_t`` with
``ε_t`` linear in the global step counter, ties of the greedy argmax to the
lowest action), the env step, and a TD error against the pre-update Q; then
the duplicate-averaged update ``Q += (lr · Σtd) / max(count, 1)`` over all N
lanes, before any lane reads Q again. Q keeps its natural ``[S, A]`` layout.
The step counter is int64 (the JAX reference's is int32 and wraps past 2³¹
env steps; the two agree below that).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .rollout_kernel import (
    STATE_DTYPES, Tables, check_smem, check_state, check_tables, check_tensor,
)

counts = LaunchCounts()

MAX_LANES = 4096   # one thread block of 1024 threads, 4 lanes each
SMEM_BYTES = 25    # per (s, a): Q, td sum, count (f32) + the 13-byte tables


@dataclasses.dataclass(frozen=True)
class TabQHyper:
    lr: float
    discount: float
    epsilon: float
    epsilon_final: float
    anneal: float  # ε anneal horizon in env steps (≥ 1)

    def f32(self):
        """``(lr, γ, ε0, εf − ε0, anneal)`` as float32, rounded the way the
        reference rounds them (the ε difference is taken in double first)."""
        return tuple(float(np.float32(v)) for v in (
            self.lr, self.discount, self.epsilon,
            self.epsilon_final - self.epsilon, self.anneal,
        ))


def tabq_reference(tables: Tables, hyper: TabQHyper, q, state, step0, rand_a, u):
    """Plain PyTorch version of the kernel: a loop over T on ``[N]`` tensors,
    gathers for the reads and ``index_add_`` for the TD sums."""
    counts.plain_calls += 1
    S, A = tables.shape
    T, N = rand_a.shape
    dev = q.device
    lr, gamma, eps0, eps_delta, anneal = (
        torch.tensor(v, dtype=torch.float32, device=dev) for v in hyper.f32()
    )
    nxt_t, rew_t = tables.next.view(-1), tables.reward.view(-1)
    hid_t, done_t = tables.hidden.view(-1), tables.done.view(-1).bool()
    q = q.clone()
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    eacc, racc, hacc, lacc = (torch.zeros_like(epr) for _ in range(4))
    reset = torch.full_like(idx, tables.reset_idx)
    ones = torch.ones(N, dtype=torch.float32, device=dev)
    for s in range(T):
        step_t = step0 + s * N
        frac = (step_t.to(torch.float32) / anneal).clamp(0.0, 1.0)
        eps_t = eps0 + frac * eps_delta
        greedy = q[idx.long()].argmax(-1).to(torch.int32)  # first max
        act = torch.where(u[s] < eps_t, rand_a[s], greedy)
        k = idx.long() * A + act.long()
        nxt, r = nxt_t[k], rew_t[k]
        t1 = t + 1
        done = done_t[k] | (t1 >= tables.max_steps)
        boot = q[nxt.long()].amax(-1)
        target = r + gamma * torch.where(done, torch.zeros_like(boot), boot)
        td = target - q.view(-1)[k]
        td_sum = torch.zeros(S * A, dtype=torch.float32, device=dev).index_add_(0, k, td)
        cnt = torch.zeros(S * A, dtype=torch.float32, device=dev).index_add_(0, k, ones)
        q = q + (lr * td_sum / cnt.clamp_min(1.0)).view(S, A)

        dx = done.to(torch.float32)
        epr = epr + r
        eph = eph + hid_t[k]
        epl = epl + 1
        eacc = eacc + dx
        racc = racc + dx * epr
        hacc = hacc + dx * eph
        lacc = lacc + dx * epl.to(torch.float32)
        idx = torch.where(done, reset, nxt)
        t = torch.where(done, torch.zeros_like(t1), t1)
        epr = torch.where(done, torch.zeros_like(epr), epr)
        eph = torch.where(done, torch.zeros_like(eph), eph)
        epl = torch.where(done, torch.zeros_like(epl), epl)
    step = step0 + T * N
    lanes = tuple(x[None] for x in (idx, t, epr, eph, epl))
    return (q,) + lanes + (step,) + tuple(x[None] for x in (eacc, racc, hacc, lacc))


def _lib():
    lib = build("tabular_kernel")["tabular_kernel"]
    fn = lib.tabq_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] * 4 + [I] * 4 + [F] * 5 + [P] * 9 + [I] * 2
                       + [P] * 12)
        fn.restype = ctypes.c_int
    return fn


def tabq(tables: Tables, hyper: TabQHyper, q, state, step0, rand_a, u):
    """T fused steps of N ≤ 4096 lanes.

    ``q`` is ``[S, A]`` f32, ``state`` the 5-tuple of ``(1, N)`` tensors,
    ``step0`` a ``(1,)`` int64 global step counter, ``rand_a`` ``[T, N]``
    int32 random actions in ``[0, A)`` and ``u`` ``[T, N]`` f32 uniforms.
    Returns ``(q, idx, t, ep_return, ep_hidden, ep_len, step, episode_acc,
    return_acc, hidden_acc, length_acc)``. CUDA tensors launch the kernel;
    CPU tensors run ``tabq_reference``."""
    if rand_a.dim() != 2:
        raise ValueError(f"rand_a: expected [T, N], got shape {tuple(rand_a.shape)}")
    T, N = rand_a.shape
    if not 1 <= N <= MAX_LANES:
        raise ValueError(
            f"the fused tabular kernel takes 1..{MAX_LANES} lanes (one thread "
            f"block spans the whole TD batch), got {N}"
        )
    S, A = tables.shape
    dev = q.device
    check_tables(tables, dev)
    check_tensor(q, torch.float32, (S, A), dev, "q")
    check_state(state, N, dev)
    check_tensor(step0, torch.int64, (1,), dev, "step0")
    check_tensor(rand_a, torch.int32, (T, N), dev, "rand_a")
    check_tensor(u, torch.float32, (T, N), dev, "u")
    if dev.type == "cpu":
        return tabq_reference(tables, hyper, q, state, step0, rand_a, u)
    if dev.type != "cuda":
        raise ValueError(f"tabq: unsupported device {dev}")
    check_smem(SMEM_BYTES * S * A, tables)
    fn = _lib()
    q_o = torch.empty((S, A), dtype=torch.float32, device=dev)
    lanes = tuple(torch.empty((1, N), dtype=d, device=dev) for d in STATE_DTYPES)
    step_o = torch.empty((1,), dtype=torch.int64, device=dev)
    accs = tuple(torch.empty((1, N), dtype=torch.float32, device=dev) for _ in range(4))
    with current_device(dev):
        err = fn(
            *tables.pointers(), S, A, tables.max_steps, tables.reset_idx,
            *hyper.f32(), q.data_ptr(), *(x.data_ptr() for x in state),
            step0.data_ptr(), rand_a.data_ptr(), u.data_ptr(), T, N,
            q_o.data_ptr(), *(x.data_ptr() for x in lanes), step_o.data_ptr(),
            *(x.data_ptr() for x in accs),
            stream_of(dev),
        )
    check(err, "tabq_launch")
    counts.launches += 1
    return (q_o,) + lanes + (step_o,) + accs
