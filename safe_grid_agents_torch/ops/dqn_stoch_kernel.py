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

The kernel stages the streams the env reads in tiles whose depth (128, 64,
32 or 16 steps) and the placement of the tables and the greedy row it picks
per launch from the shapes (``layout``, mirrored by the C export
``dqn_stoch_collect_geometry``). The launch path is kept short as B3's is:
the 16 outputs are views of one buffer laid out as B3's
(``dqn_kernel.carve_outputs``), and the typed entry point is kept once
built (``_fn``).
"""
from __future__ import annotations

import ctypes

import torch

from ..envs.vec import StochTables
from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .dqn_kernel import RECORD_DTYPES, CollectHyper, carve_outputs
from .rollout_kernel import SMEM_CAP, check_state, check_tensor, r16
from .stoch_rollout_kernel import check_stoch_tables, pointers

counts = LaunchCounts()

TB_DS = 16  # the reference's T-block: chunk lengths are its multiples
STREAMS = ("rand_a", "u", "bits", "stumble", "rand2")
TILES = (128, 64, 32, 16)  # the kernel's tile depths in steps, deepest first
# Where the kernel keeps the tables and the greedy row: both in shared
# memory or both in device memory (the C ``Place``).
PLACES = ("shared", "global")


def stream_count(tables: StochTables) -> int:
    """The streams the kernel stages: u and rand_a, bits (a reset coin or
    drying), stumble and rand2 (noise)."""
    return 2 + int(bool(tables.mode or tables.dry_nbits)) + 2 * int(tables.noise)


def layout_bytes(tables: StochTables, place: str, tile: int) -> int:
    """Shared memory of one block at placement ``place`` and ``tile``-step
    tiles (``layout_at`` in the .cu): two buffers of the read streams'
    tiles and, where the tables are in device memory, one of the six
    records' (32 lanes × ``tile`` steps each), the tile's ε values, then,
    where they are staged, next, reward, hidden, cand0 and cand1 (mode 2),
    done and drunk (noise), and the int32 greedy row, each at a 16-byte
    boundary."""
    S, A = tables.shape
    SA = S * A
    records = 0 if place == "shared" else len(RECORD_DTYPES)
    nbytes = 4 * 32 * tile * (2 * stream_count(tables) + records) + 4 * tile
    if place == "shared":
        nbytes += ((5 if tables.mode == 2 else 3) * r16(4 * SA) + r16(SA)
                   + (r16(S) if tables.noise else 0) + r16(4 * S))
    return nbytes


def layout(tables: StochTables) -> tuple:
    """``(placement, tile steps, shared-memory bytes)`` of a launch: the
    first placement of ``PLACES`` that fits one block at some depth, with
    the deepest tile of ``TILES`` that fits there."""
    for place in PLACES:
        for tile in TILES:
            nbytes = layout_bytes(tables, place, tile)
            if nbytes <= SMEM_CAP:
                return place, tile, nbytes
    return "global", TILES[-1], layout_bytes(tables, "global", TILES[-1])


def tile_steps(tables: StochTables) -> int:
    """Steps a draw and record tile holds (``layout``)."""
    return layout(tables)[1]


def smem_bytes(tables: StochTables) -> int:
    """Shared memory a block takes (``layout``)."""
    return layout(tables)[2]


def collect_placement(tables: StochTables) -> str:
    """Where the kernel keeps the tables and the greedy row (``layout``)."""
    return layout(tables)[0]


def kernel_geometry(tables: StochTables) -> tuple:
    """``layout`` as the built kernel computes it; needs nvcc, so only on a
    card host, where it is held against the mirror."""
    fn = _lib_handle().dqn_stoch_collect_geometry
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = None
    S, A = tables.shape
    out = (ctypes.c_longlong * 3)()
    fn(S, A, tables.mode, tables.dry_nbits, int(tables.noise), out)
    return PLACES[out[0]], int(out[1]), int(out[2])


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


def _lib_handle():
    return build("dqn_stoch_kernel")["dqn_stoch_kernel"]


def bind(lib: ctypes.CDLL):
    """The launch entry point of a build of ``csrc/dqn_stoch_kernel.cu``
    (this package's or a variant's), with its argument types set."""
    fn = lib.dqn_stoch_collect_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 7 + [I] * 7 + [P] + [F] * 3 + [I] + [P] * 11 + [I] * 2 + [P] * 2
        fn.restype = ctypes.c_int
    return fn


_fn = None  # the typed dqn_stoch_collect_launch, once built


def _lib():
    global _fn
    if _fn is None:
        _fn = bind(_lib_handle())
    return _fn


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
    row in shared memory where they fit and in device memory otherwise
    (``layout``); CPU tensors run ``dqn_stoch_collect_reference``."""
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
    buf, outs = carve_outputs(T, N, dev)
    with current_device(dev):
        err = fn(
            *pointers(tables), S, A, tables.max_steps, tables.mode, tables.r0, tables.r1,
            tables.dry_nbits, greedy.data_ptr(), *hyper.f32(), int(hyper.use_hidden),
            *(x.data_ptr() for x in state), step0.data_ptr(),
            *(x.data_ptr() for x in (rand_a, u, bits, stumble, rand2)), T, N,
            buf.data_ptr(), stream_of(dev),
        )
    check(err, "dqn_stoch_collect_launch")
    counts.launches += 1
    return outs
