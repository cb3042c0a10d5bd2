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
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import LaunchCounts
from ._build import build, check
from .rollout_kernel import (
    STATE_DTYPES, TABLE_BYTES, Tables, check_smem, check_state, check_tables,
    check_tensor,
)

counts = LaunchCounts()

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


def _check_rows(rows: PolicyRows, S: int, A: int, dev) -> None:
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


def smem_bytes(S: int, A: int) -> int:
    """Shared memory of one launch: the tables and the policy rows."""
    return TABLE_BYTES * S * A + 4 * S * (2 * A)


def _lib():
    lib = build("ppo_collect_kernel")["ppo_collect_kernel"]
    fn = lib.ppo_collect_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 4 + [P] * 6 + [I] * 2 + [P] * 18 + [P]
        fn.restype = ctypes.c_int
    return fn


def ppo_collect(tables: Tables, rows: PolicyRows, state, u):
    """One collect chunk of T steps over N lanes.

    ``rows`` is the frozen policy over all S states, ``state`` the 5-tuple
    of ``(1, N)`` lane tensors and ``u`` ``[T, N]`` f32 uniforms in [0, 1).
    Returns ``(idx, t, ep_return, ep_hidden, ep_len, episode_acc,
    return_acc, hidden_acc, length_acc)``, each ``(1, N)``, and the nine
    ``[T, N]`` record streams ``(pre_idx, pre_t, action, logp, value,
    reward, hidden, done, next_idx)``. CUDA tensors launch the kernel; CPU
    tensors run ``ppo_collect_reference``."""
    if u.dim() != 2:
        raise ValueError(f"u: expected [T, N], got shape {tuple(u.shape)}")
    T, N = u.shape
    S, A = tables.shape
    dev = u.device
    if A < 2:
        raise ValueError(f"ppo_collect needs at least two actions, got {A}")
    check_tables(tables, dev)
    _check_rows(rows, S, A, dev)
    check_state(state, N, dev)
    check_tensor(u, torch.float32, (T, N), dev, "u")
    if dev.type == "cpu":
        return ppo_collect_reference(tables, rows, state, u)
    if dev.type != "cuda":
        raise ValueError(f"ppo_collect: unsupported device {dev}")
    check_smem(smem_bytes(S, A), tables)
    fn = _lib()
    lanes = tuple(torch.empty((1, N), dtype=d, device=dev) for d in STATE_DTYPES)
    accs = tuple(torch.empty((1, N), dtype=torch.float32, device=dev) for _ in range(4))
    recs = tuple(torch.empty((T, N), dtype=d, device=dev) for d in RECORD_DTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *tables.pointers(), rows.logp.data_ptr(), rows.cdf.data_ptr(),
            rows.value.data_ptr(), S, A, tables.max_steps, tables.reset_idx,
            *(x.data_ptr() for x in state), u.data_ptr(), T, N,
            *(x.data_ptr() for x in lanes + accs + recs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "ppo_collect_launch")
    counts.launches += 1
    return lanes + accs + recs
