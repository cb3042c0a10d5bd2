"""Fused rollout of stochastic compiled envs: T steps of N lanes in one CUDA
kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/stoch_rollout_kernel.py`` (kernel
B7 of ROADMAP queue B). ``stoch_rollout`` launches
``csrc/stoch_rollout_kernel.cu`` for CUDA tensors;
``stoch_rollout_reference`` is the plain PyTorch version it is held against
(a loop over T of ``StochTables.step``), and the one it runs for CPU
tensors. The carried state and the 8 outputs are B1's.

The mechanics (envs/vec.py): coin resets (mode 1), carried resets (mode 2),
whisky's stumble and tomato's drying, all on presampled ``[T, N]`` int32
streams ``actions, bits, stumble, rand_a``. Drying shares the ``bits``
stream with the reset coin, so it comes only with a deterministic reset and
no noise (``ValueError`` otherwise).

RNG protocol of ``StochRolloutEngine`` (the port's own, like the
reference's): ``reset`` draws one coin per lane (modes 1, 2);
``draw_streams`` draws ``actions`` (uniform in ``[0, A)``) and then
``VecEnv.draw_mechanics``'s ``bits, stumble, rand_a`` from one
``torch.Generator``. The reference draws with threefry, so trajectories are
compared on identical streams, and the two engines' statistics at 5σ.
"""
from __future__ import annotations

import ctypes

import torch

from ..envs.vec import StochTables
from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .rollout_kernel import OUT_DTYPES, SMEM_CAP, check_state, check_tensor

counts = LaunchCounts()

STREAMS = ("actions", "bits", "stumble", "rand_a")


def table_bytes(tables: StochTables) -> int:
    """Shared memory the tables take: 13 bytes per (s, a), 21 in mode 2,
    plus the one-byte drunk row."""
    S, A = tables.shape
    return S * A * (21 if tables.mode == 2 else 13) + (S if tables.noise else 0)


def check_stoch_tables(tables: StochTables, device) -> None:
    shape = tables.shape
    for name, dtype in (("next", torch.int32), ("reward", torch.float32),
                        ("hidden", torch.float32), ("done", torch.uint8)):
        check_tensor(getattr(tables, name), dtype, shape, device, f"tables.{name}")
    if tables.mode == 2:
        for name in ("cand0", "cand1"):
            check_tensor(getattr(tables, name), torch.int32, shape, device, f"tables.{name}")
    if tables.noise:
        check_tensor(tables.drunk, torch.uint8, shape[:1], device, "tables.drunk")
    if tables.dry_nbits and (tables.mode or tables.noise):
        raise ValueError(
            "drying shares the bits stream with the reset coin: it needs a "
            "deterministic reset (mode 0) and no action noise"
        )


def placement(tables: StochTables, nbytes_extra: int = 0) -> str:
    """``"shared"`` if the tables (plus ``nbytes_extra`` of other shared
    memory) fit one block, else ``"global"``."""
    return "shared" if table_bytes(tables) + nbytes_extra <= SMEM_CAP else "global"


def pointers(tables: StochTables):
    opt = (tables.cand0, tables.cand1, tables.drunk)
    return ([x.data_ptr() for x in (tables.next, tables.reward, tables.hidden, tables.done)]
            + [None if x is None else x.data_ptr() for x in opt])


def stoch_rollout_reference(tables: StochTables, state, actions, bits, stumble, rand_a):
    """Plain PyTorch version of the kernel: a loop over T of the shared
    per-lane step on ``[N]`` tensors."""
    counts.plain_calls += 1
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    racc = torch.zeros_like(epr)
    eacc = torch.zeros_like(epr)
    facc = torch.zeros_like(epr)
    for s in range(actions.shape[0]):
        (idx, t, epr, eph, epl), (_, r, _, done, fin, _, _) = tables.step(
            idx, t, epr, eph, epl, actions[s], bits[s], stumble[s], rand_a[s])
        dx = done.to(torch.float32)
        racc = racc + r
        eacc = eacc + dx
        facc = facc + dx * fin
    return tuple(x[None] for x in (idx, t, epr, eph, epl, racc, eacc, facc))


def _lib():
    lib = build("stoch_rollout_kernel")["stoch_rollout_kernel"]
    fn = lib.stoch_rollout_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 8 + [P] * 9 + [I] * 2 + [P] * 9
        fn.restype = ctypes.c_int
    return fn


def stoch_rollout(tables: StochTables, state, actions, bits, stumble, rand_a):
    """T steps of N lanes on ``[T, N]`` int32 streams.

    Returns ``(idx, t, ep_return, ep_hidden, ep_len, reward_acc,
    episode_acc, finished_return_acc)``, each ``(1, N)``. CUDA tensors
    launch the kernel, with the tables in shared memory when they fit and
    in device memory otherwise; CPU tensors run
    ``stoch_rollout_reference``."""
    if actions.dim() != 2:
        raise ValueError(f"actions: expected [T, N], got shape {tuple(actions.shape)}")
    T, N = actions.shape
    dev = actions.device
    check_stoch_tables(tables, dev)
    check_state(state, N, dev)
    for x, name in zip((actions, bits, stumble, rand_a), STREAMS):
        check_tensor(x, torch.int32, (T, N), dev, name)
    if dev.type == "cpu":
        return stoch_rollout_reference(tables, state, actions, bits, stumble, rand_a)
    if dev.type != "cuda":
        raise ValueError(f"stoch_rollout: unsupported device {dev}")
    S, A = tables.shape
    fn = _lib()
    outs = tuple(torch.empty((1, N), dtype=d, device=dev) for d in OUT_DTYPES)
    with current_device(dev):
        err = fn(
            *pointers(tables), S, A, tables.max_steps, tables.mode, tables.r0, tables.r1,
            tables.dry_nbits, int(placement(tables) == "shared"),
            *(x.data_ptr() for x in state),
            *(x.data_ptr() for x in (actions, bits, stumble, rand_a)), T, N,
            *(x.data_ptr() for x in outs),
            stream_of(dev),
        )
    check(err, "stoch_rollout_launch")
    counts.launches += 1
    return outs


class StochRolloutEngine:
    """``PallasStochRolloutEngine``'s API over ``stoch_rollout``: coin-reset
    envs (absent, interrupt), carried-reset envs (friend, foe, neutral),
    whisky's noise and tomato's drying. Deterministic envs belong on
    ``RolloutEngine`` (``ValueError``)."""

    def __init__(self, cenv, n_envs: int):
        from ..envs.vec import VecEnv

        vec = VecEnv(cenv, n_envs)  # the reset and mechanics analysis
        if not vec.stochastic:
            raise ValueError(f"{cenv.name}: deterministic env — use RolloutEngine")
        check_stoch_tables(vec.tables, vec.device)
        self.vec = vec
        self.cenv = cenv
        self.n_envs = n_envs
        self.S, self.A = vec.S, vec.A
        self.max_steps = vec.max_steps
        self.device = vec.device
        self.tables = vec.tables

    def reset(self, generator=None):
        """``(idx, t, ep_return, ep_hidden, ep_len)``, each ``(1, N)``: a
        coin per lane picks the reset state in modes 1 and 2."""
        n, dev = self.n_envs, self.device
        z_i = torch.zeros((1, n), dtype=torch.int32, device=dev)
        z_f = torch.zeros((1, n), dtype=torch.float32, device=dev)
        return (self.vec.reset_indices(generator)[None], z_i, z_f, z_f.clone(), z_i.clone())

    def draw_bits(self, generator, n_steps: int) -> torch.Tensor:
        """The ``bits`` stream: tomato's packed dry coins, else reset coins."""
        return self.vec.draw_mechanics(generator, n_steps)[0]

    def draw_streams(self, generator, n_steps: int):
        """``actions, bits, stumble, rand_a``, each ``[T, N]`` int32 (module
        doc)."""
        actions = torch.randint(0, self.A, (n_steps, self.n_envs), dtype=torch.int32,
                                generator=generator, device=self.device)
        return (actions,) + self.vec.draw_mechanics(generator, n_steps)

    def run_streams(self, state, actions, bits, stumble, rand_a):
        """Raw stream entry point: the 8 per-lane outputs."""
        return stoch_rollout(self.tables, state, actions, bits, stumble, rand_a)

    def run_random_reduced(self, state, generator, n_steps: int):
        idx, t, epr, eph, epl, racc, eacc, facc = self.run_streams(
            state, *self.draw_streams(generator, n_steps))
        acc = {
            "reward_sum": racc.sum(),
            "episodes": eacc.sum().to(torch.int32),
            "finished_return_sum": facc.sum(),
        }
        return (idx, t, epr, eph, epl), acc
