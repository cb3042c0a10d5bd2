"""Fused DQN collect on stochastic compiled envs: ε-greedy act → env step →
replay record for T steps in one CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/dqn_stoch_kernel.py`` (kernel B9
of ROADMAP queue B): B3 (``ops/dqn_kernel.py``) with B7's mechanics
(``envs/vec.py::StochTables.step``). ``dqn_stoch_collect`` launches
``csrc/dqn_stoch_kernel.cu`` for CUDA tensors;
``dqn_stoch_collect_reference`` is the plain PyTorch version it is held
against, and the one it runs for CPU tensors.

Per step and lane: ε-greedy on the frozen greedy row at the index the agent
observed (pre-dry) gives the CHOSEN action, which the record stores with
that index; the env steps the DRIED index on the EFFECTIVE action (whisky's
stumble); the record's reward is the hidden one under ``--cheat``. Five
``[T, N]`` streams: ``rand_a`` (exploration actions), ``u`` (exploration
uniforms), ``bits`` (reset coins or packed dry coins), ``stumble`` and
``rand2`` (whisky's). T is a multiple of the reference's T-block ``TB_DS``
= 16 (``ValueError`` otherwise), so one chunk length is accepted or refused
alike by both packages. Warmup is the same kernel with ε pinned to 1.
"""
from __future__ import annotations

import ctypes

import torch

from ..envs.vec import StochTables
from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .dqn_kernel import RECORD_DTYPES, CollectHyper
from .rollout_kernel import STATE_DTYPES, check_state, check_tensor
from .stoch_rollout_kernel import check_stoch_tables, placement, pointers

counts = LaunchCounts()

TB_DS = 16  # the reference's T-block: chunk lengths are its multiples
STREAMS = ("rand_a", "u", "bits", "stumble", "rand2")


def dqn_stoch_collect_reference(tables: StochTables, hyper: CollectHyper, greedy, state,
                                step0, rand_a, u, bits, stumble, rand2):
    """Plain PyTorch version of the kernel: a loop over T of the shared
    per-lane step on ``[N]`` tensors, in the reference's update order."""
    counts.plain_calls += 1
    T, N = rand_a.shape
    dev = rand_a.device
    eps0, eps_delta, anneal = (
        torch.tensor(v, dtype=torch.float32, device=dev) for v in hyper.f32())
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    eacc, racc, hacc, lacc = (torch.zeros_like(epr) for _ in range(4))
    recs = tuple(torch.empty((T, N), dtype=d, device=dev) for d in RECORD_DTYPES)
    for s in range(T):
        step_t = step0 + s * N
        frac = (step_t.to(torch.float32) / anneal).clamp(0.0, 1.0)
        eps_t = eps0 + frac * eps_delta
        act = torch.where(u[s] < eps_t, rand_a[s], greedy[idx.long()])  # the chosen action
        pidx, pt = idx, t
        (idx, t, epr, eph, epl), (nxt, r, h, done, fin_r, fin_h, fin_l) = tables.step(
            pidx, pt, epr, eph, epl, act, bits[s], stumble[s], rand2[s])
        for rec, x in zip(recs, (pidx, pt, act, h if hyper.use_hidden else r, nxt,
                                 done.to(torch.int32))):
            rec[s] = x
        dx = done.to(torch.float32)
        eacc = eacc + dx
        racc = racc + dx * fin_r
        hacc = hacc + dx * fin_h
        lacc = lacc + dx * fin_l.to(torch.float32)
    lanes = tuple(x[None] for x in (idx, t, epr, eph, epl))
    accs = tuple(x[None] for x in (eacc, racc, hacc, lacc))
    return lanes + (step0 + T * N,) + accs + recs


def _lib():
    lib = build("dqn_stoch_kernel")["dqn_stoch_kernel"]
    fn = lib.dqn_stoch_collect_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] * 7 + [I] * 8 + [P] + [F] * 3 + [I] + [P] * 11 + [I] * 2
                       + [P] * 16 + [P])
        fn.restype = ctypes.c_int
    return fn


def dqn_stoch_collect(tables: StochTables, hyper: CollectHyper, greedy, state, step0,
                      rand_a, u, bits, stumble, rand2):
    """One collect chunk of T steps over N lanes of a stochastic env.

    ``greedy`` is the frozen params' ``[S]`` int32 greedy row, ``state`` the
    5-tuple of ``(1, N)`` lane tensors, ``step0`` a ``(1,)`` int64 global
    step counter, ``u`` ``[T, N]`` f32 and the other streams ``[T, N]``
    int32. Returns ``(idx, t, ep_return, ep_hidden, ep_len, step,
    episode_acc, return_acc, hidden_acc, length_acc)`` and the six ``[T,
    N]`` record streams ``(pre_idx, pre_t, action, reward, next_idx,
    done)``. CUDA tensors launch the kernel, with the tables and the greedy
    row in shared memory when they fit and in device memory otherwise; CPU
    tensors run ``dqn_stoch_collect_reference``."""
    if rand_a.dim() != 2:
        raise ValueError(f"rand_a: expected [T, N], got shape {tuple(rand_a.shape)}")
    T, N = rand_a.shape
    if T % TB_DS:
        raise ValueError(f"chunk steps {T} must be a multiple of {TB_DS}")
    S, A = tables.shape
    dev = rand_a.device
    check_stoch_tables(tables, dev)
    check_tensor(greedy, torch.int32, (S,), dev, "greedy")
    check_state(state, N, dev)
    check_tensor(step0, torch.int64, (1,), dev, "step0")
    for x, name in zip((rand_a, u, bits, stumble, rand2), STREAMS):
        check_tensor(x, torch.float32 if name == "u" else torch.int32, (T, N), dev, name)
    if dev.type == "cpu":
        return dqn_stoch_collect_reference(tables, hyper, greedy, state, step0, rand_a, u,
                                           bits, stumble, rand2)
    if dev.type != "cuda":
        raise ValueError(f"dqn_stoch_collect: unsupported device {dev}")
    fn = _lib()
    lanes = tuple(torch.empty((1, N), dtype=d, device=dev) for d in STATE_DTYPES)
    step_o = torch.empty((1,), dtype=torch.int64, device=dev)
    accs = tuple(torch.empty((1, N), dtype=torch.float32, device=dev) for _ in range(4))
    recs = tuple(torch.empty((T, N), dtype=d, device=dev) for d in RECORD_DTYPES)
    with current_device(dev):
        err = fn(
            *pointers(tables), S, A, tables.max_steps, tables.mode, tables.r0, tables.r1,
            tables.dry_nbits, int(placement(tables, S) == "shared"), greedy.data_ptr(),
            *hyper.f32(), int(hyper.use_hidden), *(x.data_ptr() for x in state),
            step0.data_ptr(), *(x.data_ptr() for x in (rand_a, u, bits, stumble, rand2)),
            T, N, *(x.data_ptr() for x in lanes), step_o.data_ptr(),
            *(x.data_ptr() for x in accs), *(x.data_ptr() for x in recs),
            stream_of(dev),
        )
    check(err, "dqn_stoch_collect_launch")
    counts.launches += 1
    return lanes + (step_o,) + accs + recs
