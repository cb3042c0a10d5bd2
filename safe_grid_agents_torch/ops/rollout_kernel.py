"""Fused rollout: T env steps of N lanes in one CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/rollout_kernel.py`` (kernel B1 of
ROADMAP queue B). ``rollout`` launches ``csrc/rollout_kernel.cu`` for CUDA
tensors; ``rollout_reference`` is the plain PyTorch version it is held
against, and the one ``rollout`` runs for CPU tensors.

The carried state is the JAX engine's 5-tuple ``(idx, t, ep_return,
ep_hidden, ep_len)``, each ``(1, N)``, so chunked calls compose; a call
returns it together with three per-lane accumulators ``(reward sum,
episodes, finished-return sum)``. Scope: deterministic-reset compiled envs.

The kernel packs each (s, a) entry into one 16-byte word in its prologue
(``packed_entries`` mirrors it), so that a step's chain is one shared-memory
load, and stages the action stream in 128-step tiles (``smem_bytes``
mirrors its shared-memory layout). Tables whose packed form does not fit one
block's shared memory (conveyor, sokoban2) stay in device memory
(``placement``): the wrapper packs them once with ``packed_entries``, kept
on the ``Tables`` object, and the kernel reads each step's entry from L2.
``ShardedRolloutEngine`` splits the lanes over the ranks of a data group
and launches the same kernel on each rank's share (the reference's
``ShardedPallasRolloutEngine``, ``shard_map`` around the kernel).
The launch path is kept short, as B3's is (``ops/dqn_kernel.py``): the 8
outputs are views of one allocation (``carve_outputs``), the tables are
checked once when they are built (``Tables``), and the typed entry point is
kept once built (``_fn``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from ..parallel.collectives import all_gather_lanes, psum
from . import LaunchCounts
from ._build import build, check, current_device, stream_of

counts = LaunchCounts()         # launches with the tables in shared memory
global_counts = LaunchCounts()  # ... in device memory

SMEM_CAP = 232448  # bytes of dynamic shared memory one block may use
STATE_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.int32)
TILE = 128         # steps per action tile of the kernel
TILE_BYTES = 2 * 4 * 32 * TILE  # the two action tile buffers of a 32-lane block
PACKED_BYTES = 16  # per (s, a) in the kernel's packed table


@dataclasses.dataclass(frozen=True)
class Tables:
    """A compiled env's transition tables in the kernels' layout."""

    next: torch.Tensor    # [S, A] i32
    reward: torch.Tensor  # [S, A] f32
    hidden: torch.Tensor  # [S, A] f32
    done: torch.Tensor    # [S, A] u8
    max_steps: int
    reset_idx: int
    # Forms of the tables built once for the kernels' device-memory
    # placements (``cached``).
    _cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        # Checked once here, so that a wrapper only compares the device on
        # each launch (``check_tables``).
        shape = tuple(self.next.shape)
        if len(shape) != 2:
            raise ValueError(f"tables.next: expected [S, A], got shape {shape}")
        for name, dtype in (("next", torch.int32), ("reward", torch.float32),
                            ("hidden", torch.float32), ("done", torch.uint8)):
            check_tensor(getattr(self, name), dtype, shape, self.next.device, f"tables.{name}")

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

    def cached(self, key: str, make):
        """``make(self)``, built at the first call for ``key`` and kept."""
        out = self._cache.get(key)
        if out is None:
            out = self._cache[key] = make(self)
        return out


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
    """The tables' dtypes, shapes and contiguity were checked when they were
    built; here only their device."""
    if tables.next.device != device:
        raise ValueError(f"tables: expected them on {device}, got {tables.next.device}")


def check_state(state, n: int, device) -> None:
    if len(state) != 5:
        raise ValueError(f"state: expected 5 tensors, got {len(state)}")
    names = ("idx", "t", "ep_return", "ep_hidden", "ep_len")
    for x, dtype, name in zip(state, STATE_DTYPES, names):
        check_tensor(x, dtype, (1, n), device, f"state.{name}")


def r16(n: int) -> int:
    """``n`` rounded up to a multiple of 16: the kernels put each array they
    stage into shared memory at a 16-byte boundary."""
    return -(-n // 16) * 16


def smem_bytes(S: int, A: int, tables_in_smem: bool = True) -> int:
    """Shared memory of one block of ``rollout``'s kernel: the action tiles,
    then, where the tables are in shared memory, the packed table (16 bytes
    a (s, a)) and the raw tables it is packed from, next, reward, hidden
    (4·S·A bytes each) and done (S·A), each at a 16-byte boundary
    (``layout`` in the .cu)."""
    if not tables_in_smem:
        return TILE_BYTES
    SA = S * A
    return TILE_BYTES + PACKED_BYTES * SA + 3 * r16(4 * SA) + r16(SA)


def placement(S: int, A: int) -> str:
    """Where ``rollout``'s kernel keeps the tables: ``"shared"`` if its
    shared-memory layout fits one block, else ``"global"`` (device memory,
    packed once by the wrapper). Raises ``ValueError`` for a shape neither
    takes: the packed row offsets are int32 byte offsets."""
    if PACKED_BYTES * S * A > 0x7FFFFFFF:
        raise ValueError(f"tables of shape ({S}, {A}): {PACKED_BYTES * S * A} bytes packed; "
                         "the kernel's int32 byte offsets reach 2^31 - 1")
    return "shared" if smem_bytes(S, A) <= SMEM_CAP else "global"


def packed_entries(tables: Tables) -> torch.Tensor:
    """``[S·A, 4]`` int32: the kernel's packed table as its prologue builds
    it. Per (s, a): the byte offset of the successor's row (succ · A · 16,
    the successor being the reset state where the entry is done), the
    reward's and the hidden reward's float bits, and the done flag."""
    A = tables.shape[1]
    done = tables.done.view(-1) != 0
    succ = torch.where(done, torch.full_like(tables.next.view(-1), tables.reset_idx),
                       tables.next.view(-1))
    return torch.stack((succ * (PACKED_BYTES * A), tables.reward.view(-1).view(torch.int32),
                        tables.hidden.view(-1).view(torch.int32), done.to(torch.int32)), 1)


def kernel_smem_bytes(S: int, A: int, tables_in_smem: bool = True) -> int:
    """``smem_bytes`` as the built kernel computes it; needs nvcc, so only
    on a card host, where it is held against the mirror."""
    fn = _lib_handle().rollout_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(S, A, int(tables_in_smem)))


def kernel_placement(S: int, A: int) -> str:
    """``placement`` as the built kernel decides it (card host only)."""
    fn = _lib_handle().rollout_placement
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return "shared" if fn(S, A) else "global"


def device_packed(tables: Tables) -> torch.Tensor:
    """The packed table of the device-memory placement, built once per
    ``Tables`` (``packed_entries``)."""
    return tables.cached("rollout_packed", lambda t: packed_entries(t).contiguous())


def carve_outputs(N: int, device) -> tuple:
    """``(buffer, outputs)``: the 8 ``(1, N)`` outputs as views of one
    buffer of ``8·N`` 4-byte words, in the order ``rollout`` returns them:
    the int32 ones (idx, t, ep_len) first, then the float32 ones
    (ep_return, ep_hidden, reward_acc, episode_acc, finished_return_acc),
    each group cut by one ``unbind``."""
    buf = torch.empty(8 * N, dtype=torch.int32, device=device)
    i = buf.as_strided((3, 1, N), (N, N, 1)).unbind(0)
    f = buf.view(torch.float32).as_strided((5, 1, N), (N, N, 1), 3 * N).unbind(0)
    return buf, (i[0], i[1], f[0], f[1], i[2], *f[2:])


# Word offsets of the 8 outputs, in the order the launch takes them, in the
# buffer of ``carve_outputs``.
OUT_WORDS = (0, 1, 3, 4, 2, 5, 6, 7)


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


def _lib_handle():
    return build("rollout_kernel")["rollout_kernel"]


def bind(lib: ctypes.CDLL):
    """The launch entry point of a build of ``csrc/rollout_kernel.cu`` (this
    package's, a parent's or a traced one), with its argument types set."""
    fn = lib.rollout_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, P, P, P, P, P, P, I, I] + [P] * 10
        fn.restype = ctypes.c_int
    return fn


_fn = None  # the typed rollout_launch, once built


def _lib():
    global _fn
    if _fn is None:
        _fn = bind(_lib_handle())
    return _fn


def rollout(tables: Tables, state, actions: torch.Tensor):
    """T steps of N lanes: ``actions`` is ``[T, N]`` int32 in ``[0, A)``.

    Returns ``(idx, t, ep_return, ep_hidden, ep_len, reward_acc, episode_acc,
    finished_return_acc)``, each ``(1, N)``. CUDA tensors launch the kernel,
    with the tables in shared memory or in device memory (``placement``);
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
    gpack = None if placement(S, A) == "shared" else device_packed(tables).data_ptr()
    fn = _lib()
    buf, outs = carve_outputs(N, dev)
    base = buf.data_ptr()
    with current_device(dev):
        err = fn(
            *tables.pointers(), S, A, tables.max_steps, tables.reset_idx,
            *(x.data_ptr() for x in state), actions.data_ptr(), T, N,
            *(base + 4 * w * N for w in OUT_WORDS),
            stream_of(dev), gpack,
        )
    check(err, "rollout_launch")
    (counts if gpack is None else global_counts).launches += 1
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


def reduce_totals(racc: torch.Tensor, eacc: torch.Tensor, facc: torch.Tensor, group) -> dict:
    """The chunk totals of ``run_random_reduced`` from a rank's per-lane
    accumulators, summed in float64 and over ``group``'s ranks in ONE
    all-reduce of the three sums (NCCL reduces no bool). Gridworld rewards
    are multiples of 0.5 and counts are integers, so the totals are exact,
    and equal to the single engine's float32 sums, while those stay below
    2²⁴."""
    tot = psum(torch.stack((racc, facc, eacc)).sum((1, 2), dtype=torch.float64), group)
    return {
        "reward_sum": tot[0].to(torch.float32),
        "episodes": tot[2].to(torch.int32),
        "finished_return_sum": tot[1].to(torch.float32),
    }


class ShardedRolloutEngine:
    """``ShardedPallasRolloutEngine``'s API over ``rollout`` on a data group
    (``parallel.DataGroup``): each rank owns lanes ``[r·N/W, (r+1)·N/W)``.

    The kernel is lane-parallel (per-lane state, no cross-lane reads), so
    sharding is a lane split around the same kernel B1 launched unchanged
    per rank. Every rank draws the GLOBAL ``[T, N]`` action matrix with the
    single engine's one ``randint`` and launches on its own columns (made
    contiguous), so each lane's trajectory is bitwise the single engine's;
    the chunk totals are all-reduced (``reduce_totals``), the only
    collective. The carried state stays lane-sharded: ``(1, N/W)`` a rank."""

    def __init__(self, cenv, n_envs: int, group):
        self.group = group
        self.lanes = group.lanes(n_envs)  # raises unless W divides N
        self.engine = RolloutEngine(cenv, n_envs)  # tables and the draw protocol
        self.cenv = cenv
        self.n_envs = n_envs
        self.n_local = n_envs // group.world_size
        self.A = self.engine.A
        self.reset_idx = self.engine.reset_idx
        self.device = self.engine.device

    def reset(self):
        """This rank's lanes at the deterministic reset."""
        return reset_state(self.n_local, self.reset_idx, self.device)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a global ``[T, N]`` (or ``(1, N)``) tensor."""
        return x[:, self.lanes].contiguous()

    def run_actions(self, state, actions_tn: torch.Tensor):
        """B1 on this rank's columns of the GLOBAL ``[T, N]`` actions; the 8
        per-lane outputs of this rank's lanes."""
        return rollout(self.engine.tables, state, self.shard(actions_tn))

    def run_random_reduced(self, state, generator: torch.Generator, n_steps: int):
        """The single engine's protocol (one global ``[T, N]`` randint from
        ``generator``, which every rank seeds alike), this rank's lanes,
        totals over all ranks."""
        actions = torch.randint(0, self.A, (n_steps, self.n_envs), dtype=torch.int32,
                                generator=generator, device=self.device)
        idx, t, epr, eph, epl, racc, eacc, facc = self.run_actions(state, actions)
        return (idx, t, epr, eph, epl), reduce_totals(racc, eacc, facc, self.group)

    def gather(self, outs):
        """Lane-sharded ``(1, N/W)`` tensors made whole ``(1, N)`` on every
        rank (tests and checks; not on the rollout's path)."""
        return tuple(all_gather_lanes(x, self.group) for x in outs)
