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
``ShardedStochRolloutEngine`` splits the lanes over the ranks of a data
group around the same kernel (the reference's
``ShardedPallasStochRolloutEngine``).
"""
from __future__ import annotations

import ctypes

import torch

from ..envs.vec import StochTables
from ..parallel.collectives import all_gather_lanes
from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .rollout_kernel import SMEM_CAP, check_state, check_tensor, r16, reduce_totals

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


TB = 16  # steps per stream tile of the kernel


def stream_count(tables: StochTables) -> int:
    """The streams the kernel reads: actions, bits (a reset coin or
    drying), stumble and rand_a (noise)."""
    return 1 + int(bool(tables.mode or tables.dry_nbits)) + 2 * int(tables.noise)


def smem_bytes(tables: StochTables, tables_in_smem: bool = True) -> int:
    """Shared memory of one launch (``layout`` in the .cu): two buffers of
    the read streams' tiles (32 lanes × TB steps each), then, where the
    tables are staged, next, reward, hidden, cand0 and cand1 (mode 2),
    done and drunk (noise), each at a 16-byte boundary."""
    S, A = tables.shape
    SA = S * A
    tiles = 2 * stream_count(tables) * 4 * 32 * TB
    if not tables_in_smem:
        return tiles
    return (tiles + (5 if tables.mode == 2 else 3) * r16(4 * SA) + r16(SA)
            + (r16(S) if tables.noise else 0))


def rollout_placement(tables: StochTables) -> str:
    """Where the kernel keeps the tables: ``"shared"`` if they fit beside
    the stream tiles (``smem_bytes``), else ``"global"``."""
    return "shared" if smem_bytes(tables) <= SMEM_CAP else "global"


def kernel_smem_bytes(tables: StochTables, tables_in_smem: bool = True) -> int:
    """``smem_bytes`` as the built kernel computes it; needs nvcc, so only
    on a card host, where it is held against the mirror."""
    fn = _lib_handle().stoch_rollout_smem_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    S, A = tables.shape
    return int(fn(S, A, tables.mode, tables.dry_nbits, int(tables.noise),
                  int(tables_in_smem)))


def carve_outputs(N: int, device) -> tuple:
    """``(buffer, outputs)``: the 8 ``(1, N)`` outputs as views of one
    buffer of ``8·N`` 4-byte words, in the order ``stoch_rollout`` returns
    them: the int32 ones (idx, t, ep_len) first, then the float32 ones
    (ep_return, ep_hidden, reward_acc, episode_acc, finished_return_acc),
    each group cut by one ``unbind``."""
    buf = torch.empty(8 * N, dtype=torch.int32, device=device)
    i = buf.as_strided((3, 1, N), (N, N, 1)).unbind(0)
    f = buf.view(torch.float32).as_strided((5, 1, N), (N, N, 1), 3 * N).unbind(0)
    return buf, (i[0], i[1], f[0], f[1], i[2], *f[2:])


# Word offsets of the 8 outputs, in the order the launch takes them, in the
# buffer of ``carve_outputs``.
OUT_WORDS = (0, 1, 3, 4, 2, 5, 6, 7)


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


def _lib_handle():
    return build("stoch_rollout_kernel")["stoch_rollout_kernel"]


_fn = None  # the typed stoch_rollout_launch, once built


def _lib():
    global _fn
    if _fn is None:
        fn = _lib_handle().stoch_rollout_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 8 + [P] * 9 + [I] * 2 + [P] * 9
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def stoch_rollout(tables: StochTables, state, actions, bits, stumble, rand_a):
    """T steps of N lanes on ``[T, N]`` int32 streams.

    Returns ``(idx, t, ep_return, ep_hidden, ep_len, reward_acc,
    episode_acc, finished_return_acc)``, each ``(1, N)``. CUDA tensors
    launch the kernel, with the tables in shared memory when they fit
    beside the stream tiles and in device memory otherwise
    (``rollout_placement``); CPU tensors run ``stoch_rollout_reference``."""
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
    buf, outs = carve_outputs(N, dev)
    base = buf.data_ptr()
    with current_device(dev):
        err = fn(
            *pointers(tables), S, A, tables.max_steps, tables.mode, tables.r0, tables.r1,
            tables.dry_nbits, int(rollout_placement(tables) == "shared"),
            *(x.data_ptr() for x in state),
            *(x.data_ptr() for x in (actions, bits, stumble, rand_a)), T, N,
            *(base + 4 * w * N for w in OUT_WORDS),
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


class ShardedStochRolloutEngine:
    """``ShardedPallasStochRolloutEngine``'s API over ``stoch_rollout`` on a
    data group: the stochastic counterpart of ``rollout_kernel.
    ShardedRolloutEngine``. The streams are per-lane too, so every rank
    draws the reset coins and the four ``[T, N]`` streams GLOBALLY under the
    single engine's protocol (an engine over all N lanes, as the
    reference's ``_wide`` engine), launches B7 unchanged on its own lane
    columns, and all-reduces the chunk totals; each lane is bitwise the
    single engine's."""

    def __init__(self, cenv, n_envs: int, group):
        self.group = group
        self.lanes = group.lanes(n_envs)  # raises unless W divides N
        self.wide = StochRolloutEngine(cenv, n_envs)  # tables and the draw protocol
        self.cenv = cenv
        self.n_envs = n_envs
        self.A = self.wide.A
        self.device = self.wide.device

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a global ``[T, N]`` (or ``(1, N)``) tensor."""
        return x[:, self.lanes].contiguous()

    def reset(self, generator=None):
        """The global reset (one coin per lane of all N), this rank's lanes."""
        return tuple(self.shard(x) for x in self.wide.reset(generator))

    def draw_streams(self, generator, n_steps: int):
        """The global ``actions, bits, stumble, rand_a``, each ``[T, N]``."""
        return self.wide.draw_streams(generator, n_steps)

    def run_streams(self, state, actions, bits, stumble, rand_a):
        """B7 on this rank's columns of the global streams."""
        return stoch_rollout(self.wide.tables, state,
                             *(self.shard(x) for x in (actions, bits, stumble, rand_a)))

    def run_random_reduced(self, state, generator, n_steps: int):
        idx, t, epr, eph, epl, racc, eacc, facc = self.run_streams(
            state, *self.draw_streams(generator, n_steps))
        return (idx, t, epr, eph, epl), reduce_totals(racc, eacc, facc, self.group)

    def gather(self, outs):
        """Lane-sharded ``(1, N/W)`` tensors made whole on every rank."""
        return tuple(all_gather_lanes(x, self.group) for x in outs)
