"""Fused rollout: T env steps of N lanes in one CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/rollout_kernel.py`` (kernel B1 of
ROADMAP queue B). ``rollout`` launches ``csrc/rollout_kernel.cu`` for CUDA
tensors; ``rollout_reference`` is the plain PyTorch version it is held
against, and the one ``rollout`` runs for CPU tensors.

The carried state is the JAX engine's 5-tuple ``(idx, t, ep_return,
ep_hidden, ep_len)``, each ``(1, N)``, so chunked calls compose; a call
returns it together with three per-lane accumulators ``(reward sum,
episodes, finished-return sum)``. Scope: deterministic-reset compiled envs.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from . import LaunchCounts
from ._build import build, check

counts = LaunchCounts()

SMEM_CAP = 232448  # bytes of dynamic shared memory one block may use
TABLE_BYTES = 13   # per (s, a): next i32, reward f32, hidden f32, done u8
STATE_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.int32)
OUT_DTYPES = STATE_DTYPES + (torch.float32,) * 3


@dataclasses.dataclass(frozen=True)
class Tables:
    """A compiled env's transition tables in the kernels' layout."""

    next: torch.Tensor    # [S, A] i32
    reward: torch.Tensor  # [S, A] f32
    hidden: torch.Tensor  # [S, A] f32
    done: torch.Tensor    # [S, A] u8
    max_steps: int
    reset_idx: int

    @classmethod
    def from_env(cls, cenv, reset_idx: int) -> "Tables":
        return cls(
            next=cenv.next_table.to(torch.int32).contiguous(),
            reward=cenv.reward_table.to(torch.float32).contiguous(),
            hidden=cenv.hidden_table.to(torch.float32).contiguous(),
            done=cenv.done_table.to(torch.uint8).contiguous(),
            max_steps=int(cenv.max_steps),
            reset_idx=int(reset_idx),
        )

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.next.shape)

    def pointers(self):
        return [x.data_ptr() for x in (self.next, self.reward, self.hidden, self.done)]


def reset_state(n: int, reset_idx: int, device) -> Tuple[torch.Tensor, ...]:
    """The carried 5-tuple of ``n`` lanes at a deterministic reset."""
    return (
        torch.full((1, n), reset_idx, dtype=torch.int32, device=device),
        torch.zeros((1, n), dtype=torch.int32, device=device),
        torch.zeros((1, n), dtype=torch.float32, device=device),
        torch.zeros((1, n), dtype=torch.float32, device=device),
        torch.zeros((1, n), dtype=torch.int32, device=device),
    )


def check_tensor(x: torch.Tensor, dtype, shape, device, name: str) -> None:
    # The passing case first, in as few tensor attribute reads as possible:
    # the wrappers check every input on every launch.
    if x.dtype == dtype and x.shape == tuple(shape) and x.device == device and x.is_contiguous():
        return
    raise ValueError(
        f"{name}: expected a contiguous {dtype} tensor of shape "
        f"{tuple(shape)} on {device}, got {x.dtype} {tuple(x.shape)} on "
        f"{x.device}{'' if x.is_contiguous() else ' (not contiguous)'}"
    )


def check_tables(tables: Tables, device) -> None:
    shape = tables.shape
    for name, dtype in (("next", torch.int32), ("reward", torch.float32),
                        ("hidden", torch.float32), ("done", torch.uint8)):
        check_tensor(getattr(tables, name), dtype, shape, device, f"tables.{name}")


def check_state(state, n: int, device) -> None:
    if len(state) != 5:
        raise ValueError(f"state: expected 5 tensors, got {len(state)}")
    names = ("idx", "t", "ep_return", "ep_hidden", "ep_len")
    for x, dtype, name in zip(state, STATE_DTYPES, names):
        check_tensor(x, dtype, (1, n), device, f"state.{name}")


def check_smem(nbytes: int, tables: Tables) -> None:
    if nbytes > SMEM_CAP:
        raise ValueError(
            f"tables of shape {tables.shape} need {nbytes} bytes of shared "
            f"memory; a block can use at most {SMEM_CAP}"
        )


def rollout_reference(tables: Tables, state, actions: torch.Tensor):
    """Plain PyTorch version of the kernel: a loop over T on ``[N]`` tensors
    with table gathers, in the reference's update order."""
    counts.plain_calls += 1
    A = tables.shape[1]
    nxt_t, rew_t = tables.next.view(-1), tables.reward.view(-1)
    hid_t, done_t = tables.hidden.view(-1), tables.done.view(-1).bool()
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    racc = torch.zeros_like(epr)
    eacc = torch.zeros_like(epr)
    facc = torch.zeros_like(epr)
    reset = torch.full_like(idx, tables.reset_idx)
    for a in actions:
        k = idx.long() * A + a.long()
        nxt, r = nxt_t[k], rew_t[k]
        t1 = t + 1
        done = done_t[k] | (t1 >= tables.max_steps)
        dx = done.to(torch.float32)
        epr = epr + r
        eph = eph + hid_t[k]
        epl = epl + 1
        racc = racc + r
        eacc = eacc + dx
        facc = facc + dx * epr
        idx = torch.where(done, reset, nxt)
        t = torch.where(done, torch.zeros_like(t1), t1)
        epr = torch.where(done, torch.zeros_like(epr), epr)
        eph = torch.where(done, torch.zeros_like(eph), eph)
        epl = torch.where(done, torch.zeros_like(epl), epl)
    return tuple(x[None] for x in (idx, t, epr, eph, epl, racc, eacc, facc))


def _lib():
    lib = build("rollout_kernel")["rollout_kernel"]
    fn = lib.rollout_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, P, P, P, P, P, P, I, I] + [P] * 9
        fn.restype = ctypes.c_int
    return fn


def rollout(tables: Tables, state, actions: torch.Tensor):
    """T steps of N lanes: ``actions`` is ``[T, N]`` int32 in ``[0, A)``.

    Returns ``(idx, t, ep_return, ep_hidden, ep_len, reward_acc, episode_acc,
    finished_return_acc)``, each ``(1, N)``. CUDA tensors launch the kernel;
    CPU tensors run ``rollout_reference``."""
    if actions.dim() != 2:
        raise ValueError(f"actions: expected [T, N], got shape {tuple(actions.shape)}")
    T, N = actions.shape
    dev = actions.device
    check_tables(tables, dev)
    check_state(state, N, dev)
    check_tensor(actions, torch.int32, (T, N), dev, "actions")
    if dev.type == "cpu":
        return rollout_reference(tables, state, actions)
    if dev.type != "cuda":
        raise ValueError(f"rollout: unsupported device {dev}")
    S, A = tables.shape
    check_smem(TABLE_BYTES * S * A, tables)
    fn = _lib()
    outs = tuple(torch.empty((1, N), dtype=d, device=dev) for d in OUT_DTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *tables.pointers(), S, A, tables.max_steps, tables.reset_idx,
            *(x.data_ptr() for x in state), actions.data_ptr(), T, N,
            *(x.data_ptr() for x in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "rollout_launch")
    counts.launches += 1
    return outs


class RolloutEngine:
    """``PallasRolloutEngine``'s API over ``rollout`` (deterministic-reset
    compiled envs; the tables live on the compiled env's device)."""

    def __init__(self, cenv, n_envs: int):
        from ..envs.vec import VecEnv

        vec = VecEnv(cenv, n_envs)  # the reset analysis
        if vec.stochastic:
            raise ValueError(f"{cenv.name}: stochastic env — use "
                             "ops/stoch_rollout_kernel.py::StochRolloutEngine")
        self.cenv = cenv
        self.n_envs = n_envs
        self.S, self.A = vec.S, vec.A
        self.max_steps = vec.max_steps
        self.reset_idx = vec.reset_idx
        self.device = cenv.device
        self.tables = Tables.from_env(cenv, self.reset_idx)

    def reset(self):
        """Deterministic reset: (idx, t, ep_return, ep_hidden, ep_len), each
        ``(1, N)`` — the full carried state, so chunked calls compose."""
        return reset_state(self.n_envs, self.reset_idx, self.device)

    def run_actions(self, state, actions_tn: torch.Tensor):
        """Raw action-matrix entry point: the 8 per-lane outputs."""
        return rollout(self.tables, state, actions_tn)

    def run_random_reduced(self, state, generator: torch.Generator, n_steps: int):
        """Uniform random actions drawn as ONE ``[T, N]`` int32 matrix from
        ``generator`` (on the engine's device), chunk totals out."""
        actions = torch.randint(
            0, self.A, (n_steps, self.n_envs), dtype=torch.int32,
            generator=generator, device=self.device,
        )
        idx, t, epr, eph, epl, racc, eacc, facc = rollout(self.tables, state, actions)
        acc = {
            "reward_sum": racc.sum(),
            "episodes": eacc.sum().to(torch.int32),
            "finished_return_sum": facc.sum(),
        }
        return (idx, t, epr, eph, epl), acc
