"""Fused PPO collect: inverse-CDF act → env step → rollout records for T
steps in one CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/ppo_collect_kernel.py`` (kernel
B5 of ROADMAP queue B). ``ppo_collect`` launches
``csrc/ppo_collect_kernel.cu`` for CUDA tensors; ``ppo_collect_reference``
is the plain PyTorch version it is held against, and the one
``ppo_collect`` runs for CPU tensors.

During a collect chunk the table-net policy's parameters are frozen, so
the caller evaluates the actor once over all S states into policy rows:
``logp [S, A]`` (log-softmax of the logits), ``cdf [S, A−1]`` (the
cumulative softmax without its last entry) and ``value [S]``. Per step and
lane the kernel picks ``a = Σ_{k<A−1} (u ≥ cdf[idx, k])`` from a
presampled uniform ``u``, steps the env with auto-reset and writes nine
record streams ``(pre_idx, pre_t, action, logp, value, reward, hidden,
done, next_idx)``; the episode totals accumulate the observed reward (the
trainer picks the hidden stream under ``--cheat``). Every recorded value
is a gather of a precomputed row, so the kernel and its plain version are
bitwise equal.

The launch path is part of what a chunk pays (the trainer calls it once a
chunk, at N = 1024, T = 64 on the island preset, where the kernel itself
takes a fraction of the call): the 18 outputs are views of one allocation
(``carve_outputs``, shared with B10's wrapper), the tables are checked once
when they are built (``Tables``), the remaining checks cost a few
attribute reads each, and the device context is entered only where the
tensors' device is not the current one.

Tables and rows that do not fit one block's shared memory beside the tiles
(conveyor) stay in device memory (``placement``), read from L2; the
uniforms and records still pass through the shared tiles.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .rollout_kernel import (  # noqa: F401  (check_smem: kept for the launch tools)
    SMEM_CAP, Tables, check_smem, check_state, check_tables, check_tensor, r16,
)

counts = LaunchCounts()         # launches with the tables in shared memory
global_counts = LaunchCounts()  # ... in device memory

# (pre_idx, pre_t, action, logp, value, reward, hidden, done, next_idx), [T, N].
RECORD_DTYPES = (torch.int32, torch.int32, torch.int32, torch.float32, torch.float32,
                 torch.float32, torch.float32, torch.int32, torch.int32)


@dataclasses.dataclass(frozen=True)
class PolicyRows:
    """The frozen policy over all S states."""

    logp: torch.Tensor   # [S, A] f32
    cdf: torch.Tensor    # [S, A-1] f32
    value: torch.Tensor  # [S] f32

    @classmethod
    def from_outputs(cls, logits: torch.Tensor, value: torch.Tensor) -> "PolicyRows":
        """Rows of the reference's ``_collect_payload`` from the actor's
        ``(logits [S, A], value [S])``."""
        return cls(
            logp=torch.log_softmax(logits, -1).contiguous(),
            cdf=torch.cumsum(torch.softmax(logits, -1), -1)[:, :-1].contiguous(),
            value=value.contiguous(),
        )


def check_rows(rows: PolicyRows, S: int, A: int, dev) -> None:
    check_tensor(rows.logp, torch.float32, (S, A), dev, "rows.logp")
    check_tensor(rows.cdf, torch.float32, (S, A - 1), dev, "rows.cdf")
    check_tensor(rows.value, torch.float32, (S,), dev, "rows.value")


def ppo_collect_reference(tables: Tables, rows: PolicyRows, state, u):
    """Plain PyTorch version of the kernel: a loop over T on ``[N]`` tensors
    with table and row gathers, in the reference's update order."""
    counts.plain_calls += 1
    A = tables.shape[1]
    T, N = u.shape
    dev = u.device
    nxt_t, rew_t = tables.next.view(-1), tables.reward.view(-1)
    hid_t, done_t = tables.hidden.view(-1), tables.done.view(-1).bool()
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    eacc, racc, hacc, lacc = (torch.zeros_like(epr) for _ in range(4))
    recs = tuple(torch.empty((T, N), dtype=d, device=dev) for d in RECORD_DTYPES)
    reset = torch.full_like(idx, tables.reset_idx)
    for s in range(T):
        i = idx.long()
        act = (u[s][:, None] >= rows.cdf[i]).sum(-1, dtype=torch.int32)
        k = i * A + act.long()
        nxt, r, h = nxt_t[k], rew_t[k], hid_t[k]
        t1 = t + 1
        done = done_t[k] | (t1 >= tables.max_steps)
        for rec, x in zip(recs, (idx, t, act, rows.logp.view(-1)[k], rows.value[i], r, h,
                                 done.to(torch.int32), nxt)):
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
    return lanes + accs + recs


TB = 16  # steps per uniform and record tile of the kernel
# Shared memory of a block besides the tables and rows: two buffers of the
# uniform tile and one of the nine records' (32 lanes × TB steps).
TILE_BYTES = 4 * 32 * TB * (2 + len(RECORD_DTYPES))


def smem_bytes(S: int, A: int, tables_in_smem: bool = True) -> int:
    """Shared memory of one launch: the tiles, then, where they are in
    shared memory, next, reward, hidden, logp (4·S·A bytes each), cdf
    (4·S·(A−1)), value (4·S) and done (S·A), each at a 16-byte boundary
    (``layout`` in the .cu)."""
    if not tables_in_smem:
        return TILE_BYTES
    SA = S * A
    return (TILE_BYTES + 4 * r16(4 * SA) + r16(4 * S * (A - 1)) + r16(4 * S)
            + r16(SA))


def placement(S: int, A: int) -> str:
    """Where the kernel keeps the tables and the policy rows: ``"shared"``
    if they fit one block beside the tiles, else ``"global"``."""
    return "shared" if smem_bytes(S, A) <= SMEM_CAP else "global"


def kernel_smem_bytes(S: int, A: int, tables_in_smem: bool = True) -> int:
    """``smem_bytes`` as the built kernel computes it; needs nvcc, so only
    on a card host, where it is held against the mirror."""
    fn = _lib_handle().ppo_collect_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(S, A, int(tables_in_smem)))


def kernel_placement(S: int, A: int) -> str:
    """``placement`` as the built kernel decides it (card host only)."""
    fn = _lib_handle().ppo_collect_placement
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return "shared" if fn(S, A) else "global"


def carve_outputs(T: int, N: int, device) -> tuple:
    """``(buffer, outputs)``: the 18 outputs of B5 and B10 as views of one
    buffer of ``9·T·N + 9·N`` 4-byte words, in the order the wrappers
    return them: ``(idx, t, ep_return, ep_hidden, ep_len)`` and the four
    accumulators, each ``(1, N)``, then the nine ``[T, N]`` records. In the
    buffer the int32 records (pre_idx, pre_t, action, done, next_idx) come
    first, then the float32 ones (logp, value, reward, hidden), then the
    int32 lanes (idx, t, ep_len) and the float32 ones (ep_return, ep_hidden
    and the accumulators), as ``ppo_collect_launch`` and
    ``ppo_stoch_collect_launch`` lay them out: the records 16-byte aligned
    for the kernels' bulk stores, and each group of one dtype cut by one
    ``unbind`` (the launch path pays for every tensor op)."""
    TN = T * N
    buf = torch.empty(9 * (T + 1) * N, dtype=torch.int32, device=device)
    flt = buf.view(torch.float32)
    ri = buf[:5 * TN].view(5, T, N).unbind(0)
    rf = flt[5 * TN:9 * TN].view(4, T, N).unbind(0)
    li = buf[9 * TN:9 * TN + 3 * N].view(3, 1, N).unbind(0)
    lf = flt[9 * TN + 3 * N:].view(6, 1, N).unbind(0)
    return buf, (li[0], li[1], lf[0], lf[1], li[2], *lf[2:],
                 ri[0], ri[1], ri[2], *rf, ri[3], ri[4])


def _lib_handle():
    return build("ppo_collect_kernel")["ppo_collect_kernel"]


_fn = None  # the typed ppo_collect_launch, once built


def _lib():
    global _fn
    if _fn is None:
        fn = _lib_handle().ppo_collect_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 4 + [P] * 6 + [I] * 2 + [P] + [P] + [I]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ppo_collect(tables: Tables, rows: PolicyRows, state, u):
    """One collect chunk of T steps over N lanes.

    ``rows`` is the frozen policy over all S states, ``state`` the 5-tuple
    of ``(1, N)`` lane tensors and ``u`` ``[T, N]`` f32 uniforms in [0, 1).
    Returns ``(idx, t, ep_return, ep_hidden, ep_len, episode_acc,
    return_acc, hidden_acc, length_acc)``, each ``(1, N)``, and the nine
    ``[T, N]`` record streams ``(pre_idx, pre_t, action, logp, value,
    reward, hidden, done, next_idx)``. CUDA tensors launch the kernel, with
    the tables and rows in shared or device memory (``placement``); CPU
    tensors run ``ppo_collect_reference``."""
    if u.dim() != 2:
        raise ValueError(f"u: expected [T, N], got shape {tuple(u.shape)}")
    T, N = u.shape
    S, A = tables.shape
    dev = u.device
    if A < 2:
        raise ValueError(f"ppo_collect needs at least two actions, got {A}")
    check_tables(tables, dev)
    check_rows(rows, S, A, dev)
    check_state(state, N, dev)
    check_tensor(u, torch.float32, (T, N), dev, "u")
    if dev.type == "cpu":
        return ppo_collect_reference(tables, rows, state, u)
    if dev.type != "cuda":
        raise ValueError(f"ppo_collect: unsupported device {dev}")
    smem = placement(S, A) == "shared"
    fn = _lib()
    buf, outs = carve_outputs(T, N, dev)
    with current_device(dev):
        err = fn(*tables.pointers(), rows.logp.data_ptr(), rows.cdf.data_ptr(),
                 rows.value.data_ptr(), S, A, tables.max_steps, tables.reset_idx,
                 *(x.data_ptr() for x in state), u.data_ptr(), T, N, buf.data_ptr(),
                 stream_of(dev), int(smem))
    check(err, "ppo_collect_launch")
    (counts if smem else global_counts).launches += 1
    return outs
