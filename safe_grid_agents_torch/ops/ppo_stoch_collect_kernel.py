"""Fused PPO collect on stochastic compiled envs: inverse-CDF act → env step
→ rollout records for T steps in one CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/ppo_stoch_collect_kernel.py``
(kernel B10 of ROADMAP queue B): B5 (``ops/ppo_collect_kernel.py``) with
B7's mechanics (``envs/vec.py::StochTables.step``).
``ppo_stoch_collect`` launches ``csrc/ppo_stoch_collect_kernel.cu`` for
CUDA tensors; ``ppo_stoch_collect_reference`` is the plain PyTorch version
it is held against, and the one it runs for CPU tensors.

Per step and lane: ``a = Σ_{k<A−1} (u ≥ cdf[idx, k])`` on the policy rows at
the index the agent observed (pre-dry) is the CHOSEN action, recorded with
its logp and the state's value; the env steps the DRIED index on the
EFFECTIVE action (whisky's stumble). Nine record streams as B5's:
``(pre_idx, pre_t, action, logp, value, reward, hidden, done, next_idx)``.
Four ``[T, N]`` streams: ``u`` (action uniforms), ``bits`` (reset coins or
packed dry coins), ``stumble`` and ``rand_a`` (whisky's). Every recorded
float is a gather, so the kernel and this plain version are bitwise equal.
T is a multiple of the reference's T-block ``TB_PS`` = 16.

The launch path is part of what a chunk pays (the trainer calls it once a
chunk): the 18 outputs are views of one allocation (``carve_outputs``:
the nine records, then the lane state and the accumulators, all 4-byte
words), the C entry point takes that buffer's address, and every input
check stays, each a few attribute reads (they guard the kernel's unchecked
table reads).
"""
from __future__ import annotations

import ctypes

import torch

from ..envs.vec import StochTables
from . import LaunchCounts
from ._build import build, check
from .ppo_collect_kernel import RECORD_DTYPES, PolicyRows, check_rows
from .rollout_kernel import STATE_DTYPES, check_state, check_tensor
from .stoch_rollout_kernel import check_stoch_tables, placement, pointers

counts = LaunchCounts()

TB_PS = 16  # the reference's T-block: chunk lengths are its multiples
STREAMS = ("u", "bits", "stumble", "rand_a")
# Shared memory of a block besides the rows and tables: two buffers of the
# four streams' tiles and one of the nine records' (32 lanes × TB_PS steps).
TILE_BYTES = 4 * 32 * TB_PS * (2 * len(STREAMS) + len(RECORD_DTYPES))


def rows_bytes(S: int, A: int) -> int:
    """Bytes of the policy rows: logp [S, A], cdf [S, A−1], value [S]."""
    return 4 * S * 2 * A


def smem_bytes(S: int, A: int) -> int:
    """Shared memory a block takes besides the tables when the rows live
    there: the rows and the stream and record tiles."""
    return rows_bytes(S, A) + TILE_BYTES


def carve_outputs(T: int, N: int, device) -> tuple:
    """``(buffer, outputs)``: the 18 outputs as views of one buffer of
    ``9·T·N + 9·N`` 4-byte words, in the order the wrapper returns them:
    ``(idx, t, ep_return, ep_hidden, ep_len)`` and the four accumulators,
    each ``(1, N)``, then the nine ``[T, N]`` records. In the buffer the
    int32 records (pre_idx, pre_t, action, done, next_idx) come first, then
    the float32 ones (logp, value, reward, hidden), then the int32 lanes
    (idx, t, ep_len) and the float32 ones (ep_return, ep_hidden and the
    accumulators), as ``ppo_stoch_collect_launch`` lays them out: the
    records 16-byte aligned for the kernel's bulk stores, and each group of
    one dtype cut by one ``unbind`` (the launch path pays for every tensor
    op)."""
    TN = T * N
    buf = torch.empty(9 * (T + 1) * N, dtype=torch.int32, device=device)
    flt = buf.view(torch.float32)
    ri = buf[:5 * TN].view(5, T, N).unbind(0)
    rf = flt[5 * TN:9 * TN].view(4, T, N).unbind(0)
    li = buf[9 * TN:9 * TN + 3 * N].view(3, 1, N).unbind(0)
    lf = flt[9 * TN + 3 * N:].view(6, 1, N).unbind(0)
    return buf, (li[0], li[1], lf[0], lf[1], li[2], *lf[2:],
                 ri[0], ri[1], ri[2], *rf, ri[3], ri[4])


def kernel_tile_bytes() -> int:
    """``TILE_BYTES`` as the built kernel computes it; needs nvcc, so only on
    a card host, where it is held against the mirror."""
    fn = build("ppo_stoch_collect_kernel")["ppo_stoch_collect_kernel"].ppo_stoch_collect_tile_bytes
    fn.restype = ctypes.c_longlong
    return int(fn())


def ppo_stoch_collect_reference(tables: StochTables, rows: PolicyRows, state, u, bits,
                                stumble, rand_a):
    """Plain PyTorch version of the kernel: a loop over T of the shared
    per-lane step on ``[N]`` tensors, with row gathers at the observed
    index."""
    counts.plain_calls += 1
    A = tables.shape[1]
    T, N = u.shape
    dev = u.device
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    eacc, racc, hacc, lacc = (torch.zeros_like(epr) for _ in range(4))
    recs = tuple(torch.empty((T, N), dtype=d, device=dev) for d in RECORD_DTYPES)
    for s in range(T):
        i = idx.long()
        act = (u[s][:, None] >= rows.cdf[i]).sum(-1, dtype=torch.int32)  # the chosen action
        pidx, pt = idx, t
        (idx, t, epr, eph, epl), (nxt, r, h, done, fin_r, fin_h, fin_l) = tables.step(
            pidx, pt, epr, eph, epl, act, bits[s], stumble[s], rand_a[s])
        for rec, x in zip(recs, (pidx, pt, act, rows.logp.view(-1)[i * A + act.long()],
                                 rows.value[i], r, h, done.to(torch.int32), nxt)):
            rec[s] = x
        dx = done.to(torch.float32)
        eacc = eacc + dx
        racc = racc + dx * fin_r
        hacc = hacc + dx * fin_h
        lacc = lacc + dx * fin_l.to(torch.float32)
    lanes = tuple(x[None] for x in (idx, t, epr, eph, epl))
    accs = tuple(x[None] for x in (eacc, racc, hacc, lacc))
    return lanes + accs + recs


def _lib():
    lib = build("ppo_stoch_collect_kernel")["ppo_stoch_collect_kernel"]
    fn = lib.ppo_stoch_collect_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 8 + [P] * 12 + [I] * 2 + [P] + [P]
        fn.restype = ctypes.c_int
    return fn


def ppo_stoch_collect(tables: StochTables, rows: PolicyRows, state, u, bits, stumble,
                      rand_a):
    """One collect chunk of T steps over N lanes of a stochastic env.

    ``rows`` is the frozen policy over all S states, ``state`` the 5-tuple
    of ``(1, N)`` lane tensors, ``u`` ``[T, N]`` f32 uniforms in [0, 1) and
    the other streams ``[T, N]`` int32. Returns ``(idx, t, ep_return,
    ep_hidden, ep_len, episode_acc, return_acc, hidden_acc, length_acc)``,
    each ``(1, N)``, and the nine ``[T, N]`` record streams. CUDA tensors
    launch the kernel, with the policy rows and the tables in shared memory
    when they fit and in device memory otherwise; CPU tensors run
    ``ppo_stoch_collect_reference``."""
    if u.dim() != 2:
        raise ValueError(f"u: expected [T, N], got shape {tuple(u.shape)}")
    T, N = u.shape
    if T % TB_PS:
        raise ValueError(f"chunk steps {T} must be a multiple of {TB_PS}")
    S, A = tables.shape
    dev = u.device
    if A < 2:
        raise ValueError(f"ppo_stoch_collect needs at least two actions, got {A}")
    check_stoch_tables(tables, dev)
    check_rows(rows, S, A, dev)
    check_state(state, N, dev)
    for x, name in zip((u, bits, stumble, rand_a), STREAMS):
        check_tensor(x, torch.float32 if name == "u" else torch.int32, (T, N), dev, name)
    if dev.type == "cpu":
        return ppo_stoch_collect_reference(tables, rows, state, u, bits, stumble, rand_a)
    if dev.type != "cuda":
        raise ValueError(f"ppo_stoch_collect: unsupported device {dev}")
    fn = _lib()
    buf, outs = carve_outputs(T, N, dev)
    with torch.cuda.device(dev):
        err = fn(
            *pointers(tables), S, A, tables.max_steps, tables.mode, tables.r0, tables.r1,
            tables.dry_nbits, int(placement(tables, smem_bytes(S, A)) == "shared"),
            rows.logp.data_ptr(), rows.cdf.data_ptr(), rows.value.data_ptr(),
            *(x.data_ptr() for x in state),
            *(x.data_ptr() for x in (u, bits, stumble, rand_a)), T, N,
            buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "ppo_stoch_collect_launch")
    counts.launches += 1
    return outs
