"""Fused DQN collect: ε-greedy act → env step → replay record for T steps in
one CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/dqn_kernel.py`` (kernel B3 of
ROADMAP queue B). ``dqn_collect`` launches ``csrc/dqn_kernel.cu`` for CUDA
tensors; ``dqn_collect_reference`` is the plain PyTorch version it is held
against, and the one ``dqn_collect`` runs for CPU tensors.

During a collect chunk the Q-net's parameters are frozen, and a compiled
env's Q is a function of the state index alone, so the caller evaluates the
net once over all S states and hands the kernel its first-max argmax as a
greedy row ``[S]``: the kernel never touches a Q value. Per step and lane:
``explore = u < ε_t`` (ε linear in the global step counter, which advances
by N per vector step), the env step with auto-reset, and one record
``(pre_idx, pre_t, action, reward, next_idx, done)`` — the reward is the
hidden one under ``--cheat`` — plus the finished-episode totals. Warmup is
the same kernel with ε pinned to 1 (``u ∈ [0, 1)`` is always below it).

The launch path is most of what a chunk pays (the trainer calls it once a
chunk at N = 128, T = 32, where the kernel itself takes a few tens of µs),
so it is kept short as B5's is (``ops/ppo_collect_kernel.py``): the 16
outputs are views of one allocation (``carve_outputs``), the tables are
checked once when they are built (``Tables``), and the typed entry point
is kept once built (``_fn``).

Tables and a greedy row that do not fit one block's shared memory beside
the tiles (conveyor) stay in device memory (``placement``), read from L2;
the draws and records still pass through the shared tiles.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .rollout_kernel import (  # noqa: F401  (check_smem: kept for the launch tools)
    SMEM_CAP, Tables, check_smem, check_state, check_tables, check_tensor, r16,
)

counts = LaunchCounts()         # launches with the tables in shared memory
global_counts = LaunchCounts()  # ... in device memory

# (pre_idx, pre_t, action, reward, next_idx, done), each [T, N].
RECORD_DTYPES = (torch.int32, torch.int32, torch.int32, torch.float32,
                 torch.int32, torch.int32)


@dataclasses.dataclass(frozen=True)
class CollectHyper:
    epsilon: float
    epsilon_final: float
    anneal: float      # ε anneal horizon in env steps (≥ 1)
    use_hidden: bool   # record the hidden reward (--cheat)

    def f32(self):
        """``(ε0, εf − ε0, anneal)`` as float32, rounded the way the
        reference rounds them (the ε difference is taken in double first)."""
        return tuple(float(np.float32(v)) for v in (
            self.epsilon, self.epsilon_final - self.epsilon, self.anneal))

    def warmup(self) -> "CollectHyper":
        """ε pinned to 1: every action is the presampled uniform draw."""
        return dataclasses.replace(self, epsilon=1.0, epsilon_final=1.0)


def dqn_collect_reference(tables: Tables, hyper: CollectHyper, greedy, state,
                          step0, rand_a, u):
    """Plain PyTorch version of the kernel: a loop over T on ``[N]`` tensors
    with table gathers, in the reference's update order."""
    counts.plain_calls += 1
    A = tables.shape[1]
    T, N = rand_a.shape
    dev = rand_a.device
    eps0, eps_delta, anneal = (
        torch.tensor(v, dtype=torch.float32, device=dev) for v in hyper.f32())
    nxt_t, rew_t = tables.next.view(-1), tables.reward.view(-1)
    hid_t, done_t = tables.hidden.view(-1), tables.done.view(-1).bool()
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    eacc, racc, hacc, lacc = (torch.zeros_like(epr) for _ in range(4))
    recs = tuple(torch.empty((T, N), dtype=d, device=dev) for d in RECORD_DTYPES)
    reset = torch.full_like(idx, tables.reset_idx)
    for s in range(T):
        step_t = step0 + s * N
        frac = (step_t.to(torch.float32) / anneal).clamp(0.0, 1.0)
        eps_t = eps0 + frac * eps_delta
        act = torch.where(u[s] < eps_t, rand_a[s], greedy[idx.long()])
        k = idx.long() * A + act.long()
        nxt, r, h = nxt_t[k], rew_t[k], hid_t[k]
        t1 = t + 1
        done = done_t[k] | (t1 >= tables.max_steps)
        for rec, x in zip(recs, (idx, t, act, h if hyper.use_hidden else r, nxt,
                                 done.to(torch.int32))):
            rec[s] = x
        dx = done.to(torch.float32)
        epr = epr + r
        eph = eph + h
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
    lanes = tuple(x[None] for x in (idx, t, epr, eph, epl))
    accs = tuple(x[None] for x in (eacc, racc, hacc, lacc))
    return lanes + (step0 + T * N,) + accs + recs


TB = 16  # steps per draw and record tile of the kernel
# Shared memory of a block besides the tables and the greedy row: two
# buffers of the u and rand_a tiles and one of the six records' (32 lanes ×
# TB steps).
TILE_BYTES = 4 * 32 * TB * (2 * 2 + len(RECORD_DTYPES))
HEAD_WORDS = 4  # the int64 step, padded to 16 bytes, ahead of the records


def smem_bytes(S: int, A: int, tables_in_smem: bool = True) -> int:
    """Shared memory of one launch: the tiles, then, where they are in
    shared memory, next, reward, hidden (4·S·A bytes each), done (S·A) and
    the int32 greedy row (4·S), each at a 16-byte boundary (``layout`` in
    the .cu)."""
    if not tables_in_smem:
        return TILE_BYTES
    SA = S * A
    return TILE_BYTES + 3 * r16(4 * SA) + r16(SA) + r16(4 * S)


def placement(S: int, A: int) -> str:
    """Where the kernel keeps the tables and the greedy row: ``"shared"``
    if they fit one block beside the tiles, else ``"global"``."""
    return "shared" if smem_bytes(S, A) <= SMEM_CAP else "global"


def kernel_smem_bytes(S: int, A: int, tables_in_smem: bool = True) -> int:
    """``smem_bytes`` as the built kernel computes it; needs nvcc, so only
    on a card host, where it is held against the mirror."""
    fn = _lib_handle().dqn_collect_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(S, A, int(tables_in_smem)))


def kernel_placement(S: int, A: int) -> str:
    """``placement`` as the built kernel decides it (card host only)."""
    fn = _lib_handle().dqn_collect_placement
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return "shared" if fn(S, A) else "global"


def carve_outputs(T: int, N: int, device) -> tuple:
    """``(buffer, outputs)``: the 16 outputs as views of one buffer of
    ``4 + 6·T·N + 9·N`` 4-byte words, in the order ``dqn_collect`` returns
    them. In the buffer the int64 step comes first (8-byte aligned; two
    words pad the head to 16 bytes), then the int32 records (pre_idx,
    pre_t, action, next_idx, done) and the float32 one (reward), 16-byte
    aligned for the kernel's bulk stores, then the int32 lanes (idx, t,
    ep_len) and the float32 ones (ep_return, ep_hidden and the four
    accumulators), as ``dqn_collect_launch`` lays them out. The launch path
    pays for every tensor op, so each group of one dtype is one
    ``as_strided`` view cut by one ``unbind``."""
    TN = T * N
    rec, lanes = HEAD_WORDS, HEAD_WORDS + 6 * TN
    buf = torch.empty(lanes + 9 * N, dtype=torch.int32, device=device)
    flt = buf.view(torch.float32)
    step = buf[:2].view(torch.int64)
    ri = buf.as_strided((5, T, N), (TN, N, 1), rec).unbind(0)
    reward = flt.as_strided((T, N), (N, 1), rec + 5 * TN)
    li = buf.as_strided((3, 1, N), (N, N, 1), lanes).unbind(0)
    lf = flt.as_strided((6, 1, N), (N, N, 1), lanes + 3 * N).unbind(0)
    return buf, (li[0], li[1], lf[0], lf[1], li[2], step, *lf[2:],
                 ri[0], ri[1], ri[2], reward, ri[3], ri[4])


def _lib_handle():
    return build("dqn_kernel")["dqn_kernel"]


_fn = None  # the typed dqn_collect_launch, once built


def _lib():
    global _fn
    if _fn is None:
        fn = _lib_handle().dqn_collect_launch
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 5 + [I] * 4 + [F] * 3 + [I] + [P] * 8 + [I] * 2 + [P] + [P] + [I]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def dqn_collect(tables: Tables, hyper: CollectHyper, greedy, state, step0, rand_a, u):
    """One collect chunk of T steps over N lanes.

    ``greedy`` is the frozen params' ``[S]`` int32 greedy row, ``state`` the
    5-tuple of ``(1, N)`` lane tensors, ``step0`` a ``(1,)`` int64 global
    step counter, ``rand_a`` ``[T, N]`` int32 random actions in ``[0, A)``
    and ``u`` ``[T, N]`` f32 uniforms. Returns ``(idx, t, ep_return,
    ep_hidden, ep_len, step, episode_acc, return_acc, hidden_acc,
    length_acc)`` and the six ``[T, N]`` record streams ``(pre_idx, pre_t,
    action, reward, next_idx, done)``. CUDA tensors launch the kernel, with
    the tables and greedy row in shared or device memory (``placement``);
    CPU tensors run ``dqn_collect_reference``."""
    if rand_a.dim() != 2:
        raise ValueError(f"rand_a: expected [T, N], got shape {tuple(rand_a.shape)}")
    T, N = rand_a.shape
    S, A = tables.shape
    dev = rand_a.device
    check_tables(tables, dev)
    check_tensor(greedy, torch.int32, (S,), dev, "greedy")
    check_state(state, N, dev)
    check_tensor(step0, torch.int64, (1,), dev, "step0")
    check_tensor(rand_a, torch.int32, (T, N), dev, "rand_a")
    check_tensor(u, torch.float32, (T, N), dev, "u")
    if dev.type == "cpu":
        return dqn_collect_reference(tables, hyper, greedy, state, step0, rand_a, u)
    if dev.type != "cuda":
        raise ValueError(f"dqn_collect: unsupported device {dev}")
    smem = placement(S, A) == "shared"
    fn = _lib()
    buf, outs = carve_outputs(T, N, dev)
    with current_device(dev):
        err = fn(*tables.pointers(), greedy.data_ptr(), S, A, tables.max_steps,
                 tables.reset_idx, *hyper.f32(), int(hyper.use_hidden),
                 *(x.data_ptr() for x in state), step0.data_ptr(), rand_a.data_ptr(),
                 u.data_ptr(), T, N, buf.data_ptr(), stream_of(dev), int(smem))
    check(err, "dqn_collect_launch")
    (counts if smem else global_counts).launches += 1
    return outs
