"""Fused tabular-Q training: act → env step → TD learn for T steps in one
CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/tabular_kernel.py`` (kernel B2 of
ROADMAP queue B). ``tabq`` launches ``csrc/tabular_kernel.cu`` for CUDA
tensors; ``tabq_reference`` is the plain PyTorch version it is held against,
and the one ``tabq`` runs for CPU tensors.

Per step and lane: ε-greedy on presampled draws (``explore = u < ε_t`` with
``ε_t`` linear in the global step counter, ties of the greedy argmax to the
lowest action), the env step, and a TD error against the pre-update Q; then
the duplicate-averaged update ``Q += (lr · Σtd) / max(count, 1)`` over all N
lanes, before any lane reads Q again, each TD error summed as a 64-bit
fixed-point integer (2^-32 units, ``TD_SCALE``): integer sums are exact in
any order, so the kernel is deterministic and bitwise equal to this plain
version, which sums the same integers. (Float sums in another order part
the trajectories: cells whose Q should tie, such as two actions that bump
into one wall, come apart by an ulp and an argmax flips, most of all from a
hot reset.) Q keeps its natural ``[S, A]`` layout. The step counter is
int64 (the JAX reference's is int32 and wraps past 2³¹ env steps; the two
agree below that).

The kernel updates only the cells a step touched (the owner of each, the
first adder of its count, applies the averaged TD), adds each lane's TD
error with native integer atomics, and stages the draws into shared memory
in tiles of up to 32 steps (``smem_bytes`` and ``tile_steps`` mirror its
layout). Its outputs equal this plain version's dense update bitwise:
the two differ only where a Q entry is -0.0, which the dense ``q + 0.0``
turns into +0.0 and which never arises from a Q without -0.0 entries
(``tests/test_torch_tabular_launch.py`` holds a model of the kernel's step
against this one). The launch path is kept short, as B3's is
(``ops/dqn_kernel.py``): the 11 outputs are views of one allocation
(``carve_outputs``), the tables are checked once when they are built
(``Tables``), and the typed entry point is kept once built (``_fn``).

Where Q, its TD sums and counts and the packed table do not fit one block's
shared memory beside a step of draws (conveyor, 32 bytes a cell), they stay
in device memory (``placement``): Q is worked in place in the output
buffer, the sums and counts in a work area carved from the same buffer, and
the packed table is built once by the wrapper and kept on the ``Tables``
object. The kernel's update and its order are the same; the sums are native
64-bit atomics there, still exact.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .rollout_kernel import (  # noqa: F401  (check_smem: kept for the launch tests)
    SMEM_CAP, Tables, check_smem, check_state, check_tables, check_tensor, r16,
)
from .rollout_kernel import packed_entries as rollout_packed_entries

counts = LaunchCounts()         # launches with the tables in shared memory
global_counts = LaunchCounts()  # ... in device memory

MAX_LANES = 4096   # one thread block of 1024 threads, 4 lanes each
MAX_TILE = 32      # steps per draw tile of the kernel, at most
# Shared memory of the kernel besides the draw tiles: per (s, a) Q and the
# count (4 bytes each), the TD sum (8) and the packed table entry (16), each
# array at a 16-byte boundary; the ε of the two tile buffers.
PACKED_BYTES = 16
EPS_BYTES = 2 * 4 * MAX_TILE
HEAD_WORDS = 4     # the int64 step, padded to 16 bytes, ahead of Q in the output buffer
TD_SCALE = 2.0 ** 32  # fixed-point units of the TD sums


def td_sums(k: torch.Tensor, td: torch.Tensor, size: int) -> torch.Tensor:
    """``[size]`` int64: each index's sum of the TD errors ``td`` of the
    lanes ``k`` names, as 64-bit fixed-point integers (``TD_SCALE``
    units). Integer sums are exact, so the result is the same in any order
    of the lanes, on either device."""
    td_fx = torch.round(td * TD_SCALE).to(torch.int64)
    return torch.zeros(size, dtype=torch.int64, device=td.device).index_add_(0, k, td_fx)


def td_float(sums: torch.Tensor) -> torch.Tensor:
    """``td_sums``' integers back to float32, through float64."""
    return (sums.to(torch.float64) / TD_SCALE).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class TabQHyper:
    lr: float
    discount: float
    epsilon: float
    epsilon_final: float
    anneal: float  # ε anneal horizon in env steps (≥ 1)

    def __post_init__(self):
        # Rounded once: the launch path reads them on every call.
        object.__setattr__(self, "_f32", tuple(float(np.float32(v)) for v in (
            self.lr, self.discount, self.epsilon,
            self.epsilon_final - self.epsilon, self.anneal,
        )))

    def f32(self):
        """``(lr, γ, ε0, εf − ε0, anneal)`` as float32, rounded the way the
        reference rounds them (the ε difference is taken in double first)."""
        return self._f32


def tabq_reference(tables: Tables, hyper: TabQHyper, q, state, step0, rand_a, u):
    """Plain PyTorch version of the kernel: a loop over T on ``[N]`` tensors,
    gathers for the reads and ``index_add_`` of the fixed-point TD errors
    (``TD_SCALE``) for the sums."""
    counts.plain_calls += 1
    S, A = tables.shape
    T, N = rand_a.shape
    dev = q.device
    lr, gamma, eps0, eps_delta, anneal = (
        torch.tensor(v, dtype=torch.float32, device=dev) for v in hyper.f32()
    )
    nxt_t, rew_t = tables.next.view(-1), tables.reward.view(-1)
    hid_t, done_t = tables.hidden.view(-1), tables.done.view(-1).bool()
    q = q.clone()
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    eacc, racc, hacc, lacc = (torch.zeros_like(epr) for _ in range(4))
    reset = torch.full_like(idx, tables.reset_idx)
    ones = torch.ones(N, dtype=torch.float32, device=dev)
    for s in range(T):
        step_t = step0 + s * N
        frac = (step_t.to(torch.float32) / anneal).clamp(0.0, 1.0)
        eps_t = eps0 + frac * eps_delta
        greedy = q[idx.long()].argmax(-1).to(torch.int32)  # first max
        act = torch.where(u[s] < eps_t, rand_a[s], greedy)
        k = idx.long() * A + act.long()
        nxt, r = nxt_t[k], rew_t[k]
        t1 = t + 1
        done = done_t[k] | (t1 >= tables.max_steps)
        boot = q[nxt.long()].amax(-1)
        target = r + gamma * torch.where(done, torch.zeros_like(boot), boot)
        td = target - q.view(-1)[k]
        td_sum = td_float(td_sums(k, td, S * A))
        cnt = torch.zeros(S * A, dtype=torch.float32, device=dev).index_add_(0, k, ones)
        q = q + (lr * td_sum / cnt.clamp_min(1.0)).view(S, A)

        dx = done.to(torch.float32)
        epr = epr + r
        eph = eph + hid_t[k]
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
    step = step0 + T * N
    lanes = tuple(x[None] for x in (idx, t, epr, eph, epl))
    return (q,) + lanes + (step,) + tuple(x[None] for x in (eacc, racc, hacc, lacc))


def packed_entries(tables: Tables) -> torch.Tensor:
    """``[S·A, 4]`` int32: the kernel's packed table as its prologue builds
    it. Per (s, a): the successor state (the reset state where the entry is
    done), the reward's and the hidden reward's float bits, and the done
    flag (B1's entries, ``rollout_kernel.packed_entries``, with the
    successor as a state index)."""
    pack = rollout_packed_entries(tables).clone()
    pack[:, 0] //= PACKED_BYTES * tables.shape[1]
    return pack


def tile_steps(S: int, A: int, N: int, T: int, tables_in_smem: bool = True) -> int:
    """Steps per draw tile of a launch: the most, up to ``MAX_TILE`` and T,
    whose two buffers (rand_a and u, 8 bytes a lane and step) fit in one
    block's shared memory beside Q and the tables, or beside the ε alone
    where those are in device memory (0: none fits)."""
    base = base_bytes(S, A, tables_in_smem)
    fit = (SMEM_CAP - base) // (16 * N) if base < SMEM_CAP else 0
    return max(min(fit, MAX_TILE, T), 0)


def base_bytes(S: int, A: int, tables_in_smem: bool = True) -> int:
    """Shared memory of a launch ahead of the draw tiles (``layout`` in the
    .cu): Q, the TD sums and the counts, the packed table (where they are
    in shared memory) and the tiles' ε."""
    SA = S * A if tables_in_smem else 0
    return 2 * r16(4 * SA) + r16(8 * SA) + PACKED_BYTES * SA + EPS_BYTES


def smem_bytes(S: int, A: int, N: int, T: int, tables_in_smem: bool = True) -> int:
    """Shared memory of a launch at these shapes: ``base_bytes`` and the two
    draw tile buffers of ``tile_steps`` steps."""
    return (base_bytes(S, A, tables_in_smem)
            + 16 * N * tile_steps(S, A, N, T, tables_in_smem))


def placement(S: int, A: int, N: int) -> str:
    """Where the kernel keeps Q and the tables: ``"shared"`` if they fit one
    block beside one step of draws, else ``"global"`` (device memory)."""
    return "shared" if tile_steps(S, A, N, 1) >= 1 else "global"


def kernel_layout(S: int, A: int, N: int, T: int, tables_in_smem: bool = True) -> tuple:
    """``(smem_bytes, tile_steps)`` as the built kernel computes them; needs
    nvcc, so only on a card host, where they are held against the mirror."""
    lib = _lib_handle()
    fb, ft = lib.tabq_smem_bytes, lib.tabq_tile_steps
    fb.argtypes = ft.argtypes = [ctypes.c_int] * 5
    fb.restype, ft.restype = ctypes.c_longlong, ctypes.c_int
    args = (S, A, N, T, int(tables_in_smem))
    return int(fb(*args)), int(ft(*args))


def kernel_placement(S: int, A: int, N: int) -> str:
    """``placement`` as the built kernel decides it (card host only)."""
    fn = _lib_handle().tabq_placement
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return "shared" if fn(S, A, N) else "global"


def device_packed(tables: Tables) -> torch.Tensor:
    """The packed table of the device-memory placement, built once per
    ``Tables`` (``packed_entries``)."""
    return tables.cached("tabq_packed", lambda t: packed_entries(t).contiguous())


def work_offset(S: int, A: int, N: int) -> int:
    """Word offset in ``carve_outputs``' buffer of the device-memory
    placement's work area (3·S·A words: the int64 TD sums, then the uint32
    counts), 16-byte aligned after the lanes."""
    return -(-(HEAD_WORDS + -(-(S * A) // 4) * 4 + 9 * N) // 4) * 4


def carve_outputs(S: int, A: int, N: int, device, work: bool = False) -> tuple:
    """``(buffer, outputs)``: the 11 outputs as views of one buffer of
    ``4 + r4(S·A) + 9·N`` 4-byte words, in the order ``tabq`` returns them.
    In the buffer the int64 step comes first (two words pad the head to 16
    bytes), then Q (16-byte aligned), then the int32 lanes (idx, t,
    ep_len) and the float32 ones (ep_return, ep_hidden and the four
    accumulators); each group of one dtype is one ``as_strided`` view cut
    by one ``unbind``. ``work`` appends the device-memory placement's work
    area (``work_offset``)."""
    SA = S * A
    lanes = HEAD_WORDS + -(-SA // 4) * 4
    size = work_offset(S, A, N) + 3 * SA if work else lanes + 9 * N
    buf = torch.empty(size, dtype=torch.int32, device=device)
    flt = buf.view(torch.float32)
    li = buf.as_strided((3, 1, N), (N, N, 1), lanes).unbind(0)
    lf = flt.as_strided((6, 1, N), (N, N, 1), lanes + 3 * N).unbind(0)
    return buf, (flt.as_strided((S, A), (A, 1), HEAD_WORDS), li[0], li[1], lf[0], lf[1],
                 li[2], buf[:2].view(torch.int64), *lf[2:])


def out_pointers(buf: torch.Tensor, S: int, A: int, N: int) -> tuple:
    """The 11 output addresses in the order the launch takes them, in the
    buffer of ``carve_outputs``."""
    base = buf.data_ptr()
    lanes = base + 4 * (HEAD_WORDS + -(-(S * A) // 4) * 4)
    return ((base + 4 * HEAD_WORDS,)
            + tuple(lanes + 4 * w * N for w in (0, 1, 3, 4, 2))
            + (base,) + tuple(lanes + 4 * w * N for w in (5, 6, 7, 8)))


def _lib_handle():
    return build("tabular_kernel")["tabular_kernel"]


def bind(lib: ctypes.CDLL):
    """The launch entry point of a build of ``csrc/tabular_kernel.cu`` (this
    package's, a parent's or a traced one), with its argument types set."""
    fn = lib.tabq_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] * 4 + [I] * 4 + [F] * 5 + [P] * 9 + [I] * 2
                       + [P] * 14)
        fn.restype = ctypes.c_int
    return fn


_fn = None  # the typed tabq_launch, once built


def _lib():
    global _fn
    if _fn is None:
        _fn = bind(_lib_handle())
    return _fn


def tabq(tables: Tables, hyper: TabQHyper, q, state, step0, rand_a, u):
    """T fused steps of N ≤ 4096 lanes.

    ``q`` is ``[S, A]`` f32, ``state`` the 5-tuple of ``(1, N)`` tensors,
    ``step0`` a ``(1,)`` int64 global step counter, ``rand_a`` ``[T, N]``
    int32 random actions in ``[0, A)`` and ``u`` ``[T, N]`` f32 uniforms.
    Returns ``(q, idx, t, ep_return, ep_hidden, ep_len, step, episode_acc,
    return_acc, hidden_acc, length_acc)``. CUDA tensors launch the kernel,
    with Q and the tables in shared memory or in device memory
    (``placement``); CPU tensors run ``tabq_reference``."""
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
    check_tables(tables, dev)
    check_tensor(q, torch.float32, (S, A), dev, "q")
    check_state(state, N, dev)
    check_tensor(step0, torch.int64, (1,), dev, "step0")
    check_tensor(rand_a, torch.int32, (T, N), dev, "rand_a")
    check_tensor(u, torch.float32, (T, N), dev, "u")
    if dev.type == "cpu":
        return tabq_reference(tables, hyper, q, state, step0, rand_a, u)
    if dev.type != "cuda":
        raise ValueError(f"tabq: unsupported device {dev}")
    smem = placement(S, A, N) == "shared"
    fn = _lib()
    buf, outs = carve_outputs(S, A, N, dev, work=not smem)
    gwork = gpack = None
    if not smem:
        gwork = buf.data_ptr() + 4 * work_offset(S, A, N)
        gpack = device_packed(tables).data_ptr()
    with current_device(dev):
        err = fn(
            *tables.pointers(), S, A, tables.max_steps, tables.reset_idx,
            *hyper.f32(), q.data_ptr(), *(x.data_ptr() for x in state),
            step0.data_ptr(), rand_a.data_ptr(), u.data_ptr(), T, N,
            *out_pointers(buf, S, A, N),
            stream_of(dev), gwork, gpack,
        )
    check(err, "tabq_launch")
    (counts if smem else global_counts).launches += 1
    return outs
