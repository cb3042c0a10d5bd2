"""Fused tabular-Q training on stochastic compiled envs: act → env step →
TD learn for T steps in one CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/tabular_stoch_kernel.py`` (kernel
B8 of ROADMAP queue B): B2 (``ops/tabular_kernel.py``) with B7's mechanics
(``envs/vec.py::StochTables.step``). ``tabq_stoch`` launches
``csrc/tabular_stoch_kernel.cu`` for CUDA tensors; ``tabq_stoch_reference``
is the plain PyTorch version it is held against, and the one it runs for
CPU tensors.

Per step and lane: ε-greedy on the observed (pre-dry) index gives the
CHOSEN action; the env steps the dried index on the EFFECTIVE action
(whisky's stumble); the TD error of the chosen action at the observed index
is taken against the pre-update Q; then ``Q += (lr · Σtd) / max(count, 1)``
over all N lanes, each TD error summed as a 64-bit fixed-point integer
(2^-32 units, ``TD_SCALE``): integer sums are exact in any order, so the
kernel is deterministic and bitwise equal to this plain version (float
atomics in a run-dependent order let the trajectories part on these envs;
csrc/tabular_stoch_kernel.cu). Five ``[T, N]`` streams: ``rand_a`` (exploration
actions), ``u`` (exploration uniforms), ``bits`` (reset coins or packed dry
coins), ``stumble`` and ``rand2`` (whisky's). N ≤ 4096 (one thread block
spans the TD batch). The kernel takes any T; the trainer keeps the
reference's chunk lengths, multiples of its T-block ``TB_TS`` = 32.

The kernel updates only the cells a step touched (the owner of each, the
first adder of its count, applies the averaged TD), sums a warp's TD
errors per cell before one atomic, and stages the streams into shared
memory in tiles of up to ``TB_TS`` steps (``kernel_tile_steps``). Its
outputs equal this plain version's dense update bitwise: the two differ
only where a Q entry is -0.0, which the dense ``q + 0.0`` turns into +0.0
and which never arises from a Q without -0.0 entries
(``tests/test_torch_tabular_stoch.py`` holds a sparse model of the update
against this one).
"""
from __future__ import annotations

import ctypes

import torch

from ..envs.vec import StochTables
from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .rollout_kernel import SMEM_CAP, STATE_DTYPES, check_state, check_tensor
from .stoch_rollout_kernel import check_stoch_tables, placement, pointers
from .tabular_kernel import MAX_LANES, TabQHyper

counts = LaunchCounts()

TB_TS = 32           # the reference's T-block: the trainer's chunks are multiples of it
Q_SMEM_BYTES = 16    # per (s, a): TD sum (i64), Q and count (f32)
AGG_BYTES = 8 * 1024  # the warps' aggregation slots: 8 bytes for each of up to 1024 threads
TD_SCALE = 2.0 ** 32  # fixed-point units of the TD sums
STREAMS = ("rand_a", "u", "bits", "stumble", "rand2")


def tabq_stoch_reference(tables: StochTables, hyper: TabQHyper, q, state, step0,
                         rand_a, u, bits, stumble, rand2):
    """Plain PyTorch version of the kernel: a loop over T on ``[N]`` tensors,
    the shared per-lane step for the env, ``index_add_`` of the fixed-point
    TD errors for the sums."""
    counts.plain_calls += 1
    S, A = tables.shape
    T, N = rand_a.shape
    dev = q.device
    lr, gamma, eps0, eps_delta, anneal = (
        torch.tensor(v, dtype=torch.float32, device=dev) for v in hyper.f32()
    )
    q = q.clone()
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    eacc, racc, hacc, lacc = (torch.zeros_like(epr) for _ in range(4))
    ones = torch.ones(N, dtype=torch.float32, device=dev)
    for s in range(T):
        step_t = step0 + s * N
        frac = (step_t.to(torch.float32) / anneal).clamp(0.0, 1.0)
        eps_t = eps0 + frac * eps_delta
        greedy = q[idx.long()].argmax(-1).to(torch.int32)  # first max
        act = torch.where(u[s] < eps_t, rand_a[s], greedy)  # the chosen action
        kc = idx.long() * A + act.long()
        (idx, t, epr, eph, epl), (nxt, r, _, done, fin_r, fin_h, fin_l) = tables.step(
            idx, t, epr, eph, epl, act, bits[s], stumble[s], rand2[s])
        boot = q[nxt.long()].amax(-1)
        target = r + gamma * torch.where(done, torch.zeros_like(boot), boot)
        td = target - q.view(-1)[kc]
        td_fx = torch.round(td * TD_SCALE).to(torch.int64)
        td_sum = torch.zeros(S * A, dtype=torch.int64, device=dev).index_add_(0, kc, td_fx)
        td_sum = (td_sum.to(torch.float64) / TD_SCALE).to(torch.float32)
        cnt = torch.zeros(S * A, dtype=torch.float32, device=dev).index_add_(0, kc, ones)
        q = q + (lr * td_sum / cnt.clamp_min(1.0)).view(S, A)
        dx = done.to(torch.float32)
        eacc = eacc + dx
        racc = racc + dx * fin_r
        hacc = hacc + dx * fin_h
        lacc = lacc + dx * fin_l.to(torch.float32)
    step = step0 + T * N
    lanes = tuple(x[None] for x in (idx, t, epr, eph, epl))
    return (q,) + lanes + (step,) + tuple(x[None] for x in (eacc, racc, hacc, lacc))


def bind(lib: ctypes.CDLL):
    """The launch entry point of a build of ``csrc/tabular_stoch_kernel.cu``
    (this package's, or a traced one), with its argument types set."""
    fn = lib.tabq_stoch_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] * 7 + [I] * 8 + [F] * 5 + [P] * 12 + [I] * 2 + [P] * 12)
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return bind(build("tabular_stoch_kernel")["tabular_stoch_kernel"])


def smem_bytes(S: int, A: int) -> int:
    """Shared memory the kernel takes besides the tables and the stream
    tiles: Q with its TD sums and counts, and the aggregation slots."""
    return Q_SMEM_BYTES * S * A + AGG_BYTES


def kernel_tile_steps(tables: StochTables, N: int, T: int) -> int:
    """Steps per shared-memory stream tile that a launch at these shapes
    uses (0: the streams are read from device memory), as the built kernel
    computes it; needs nvcc, so only on a card host."""
    S, A = tables.shape
    fn = build("tabular_stoch_kernel")["tabular_stoch_kernel"].tabq_stoch_tile_steps
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_int
    shared = placement(tables, smem_bytes(S, A)) == "shared"
    return int(fn(S, A, tables.mode, tables.dry_nbits, int(tables.noise), int(shared), N, T))


def tabq_stoch(tables: StochTables, hyper: TabQHyper, q, state, step0,
               rand_a, u, bits, stumble, rand2):
    """T fused steps of N ≤ 4096 lanes.

    ``q`` is ``[S, A]`` f32, ``state`` the 5-tuple of ``(1, N)`` tensors,
    ``step0`` a ``(1,)`` int64 global step counter, ``u`` ``[T, N]`` f32 and
    the other streams ``[T, N]`` int32. Returns ``(q, idx, t, ep_return,
    ep_hidden, ep_len, step, episode_acc, return_acc, hidden_acc,
    length_acc)``. CUDA tensors launch the kernel, with the env tables in
    shared memory when they fit beside Q and in device memory otherwise; CPU
    tensors run ``tabq_stoch_reference``."""
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
    check_stoch_tables(tables, dev)
    check_tensor(q, torch.float32, (S, A), dev, "q")
    check_state(state, N, dev)
    check_tensor(step0, torch.int64, (1,), dev, "step0")
    for x, name in zip((rand_a, u, bits, stumble, rand2), STREAMS):
        check_tensor(x, torch.float32 if name == "u" else torch.int32, (T, N), dev, name)
    if dev.type == "cpu":
        return tabq_stoch_reference(tables, hyper, q, state, step0, rand_a, u, bits,
                                    stumble, rand2)
    if dev.type != "cuda":
        raise ValueError(f"tabq_stoch: unsupported device {dev}")
    q_bytes = smem_bytes(S, A)
    if q_bytes > SMEM_CAP:
        raise ValueError(f"Q of shape {(S, A)} needs {q_bytes} bytes of shared memory "
                         f"with its TD sums, counts and aggregation slots; a block can use "
                         f"at most {SMEM_CAP}")
    fn = _lib()
    q_o = torch.empty((S, A), dtype=torch.float32, device=dev)
    lanes = tuple(torch.empty((1, N), dtype=d, device=dev) for d in STATE_DTYPES)
    step_o = torch.empty((1,), dtype=torch.int64, device=dev)
    accs = tuple(torch.empty((1, N), dtype=torch.float32, device=dev) for _ in range(4))
    with current_device(dev):
        err = fn(
            *pointers(tables), S, A, tables.max_steps, tables.mode, tables.r0, tables.r1,
            tables.dry_nbits, int(placement(tables, q_bytes) == "shared"), *hyper.f32(),
            q.data_ptr(), *(x.data_ptr() for x in state), step0.data_ptr(),
            *(x.data_ptr() for x in (rand_a, u, bits, stumble, rand2)), T, N,
            q_o.data_ptr(), *(x.data_ptr() for x in lanes), step_o.data_ptr(),
            *(x.data_ptr() for x in accs),
            stream_of(dev),
        )
    check(err, "tabq_stoch_launch")
    counts.launches += 1
    return (q_o,) + lanes + (step_o,) + accs
