"""Fused PPO optimize: every epoch × minibatch update of the table-folded
actor-critic in one C entry point (a fixed sequence of CUDA kernels on one
stream).

Counterpart of ``safe_grid_agents_tpu/ops/ppo_kernel.py`` (kernel B6 of
ROADMAP queue B). ``ppo_optimize`` launches ``csrc/ppo_kernel.cu`` for
CUDA tensors; ``ppo_optimize_reference`` is the plain PyTorch version it is
held against, and the one ``ppo_optimize`` runs for CPU tensors: U steps
of ``PPOAgent.update`` (autograd of the agent's own loss, the global-norm
clip and Adam over the flat params), so the kernel's hand-derived backward
is held against autograd.

The caller applies the tile-shuffled minibatch membership
(``training/ppo_mxu.py``) and passes the epochs-stacked streams ``[U, B]``
(state index, action, old logp, advantage, return); update u reads row u.
The parameters and Adam's moments are flat vectors in the agent's ravel
order; the loss is the mean over the U updates of each update's minibatch
mean. Scope: ``net='table'`` with two hidden layers.

Two routes, both hand-written kernels, chosen by ``route`` from the shape
alone before the launch:

* ``persistent`` (``csrc/ppo_kernel.cu``), for hidden widths up to
  ``HIDDEN_PAD`` = 128 and at most 7 actions: per update a persistent grad
  kernel, whose block b walks the fixed stripe of 64-row tiles
  ``[b·tpb, (b+1)·tpb)`` and writes one partial record, and a cooperative
  finish kernel (reduce, gw1, norm, clip, Adam, refold). ``geometry``
  mirrors its tiling, stripes and shared-memory sizing.
* ``wide`` (``csrc/ppo_wide_kernel.cu``), for wider nets or more actions:
  six kernels an update (fold, grad, reduce, gw1, norm, adam) over one grad
  block per row tile, the tile shrunk for wide nets. ``wide_geometry``
  mirrors its tile, grid, shared memory and scratch.

``counts`` counts the persistent route's launches (and the plain version's
calls), ``wide_counts`` the wide route's. A failed build or launch raises;
neither route falls back to the other or to the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..agents.ppo import PPOAgent
from ..envs.compiled import TableState
from . import LaunchCounts
from ._build import build, check, current_device, stream_of
from .rollout_kernel import SMEM_CAP, check_tensor

counts = LaunchCounts()       # the persistent route, and the plain version's calls
wide_counts = LaunchCounts()  # the wide route

STREAM_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.float32)
# Flat-layout names of w1, b1, W2, b2, the logits head (Wl, bl) and the
# value head (Wv, bv), in the order the kernel takes their offsets.
OFFSET_NAMES = ("w1", "b1", "Dense_0.kernel", "Dense_0.bias", "Dense_1.kernel",
                "Dense_1.bias", "Dense_2.kernel", "Dense_2.bias")


@dataclasses.dataclass(frozen=True)
class OptHyper:
    lr: float
    clipping: float
    value_coef: float
    max_norm: float
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    @classmethod
    def from_agent(cls, agent: PPOAgent) -> "OptHyper":
        return cls(float(agent.lr), float(agent.clipping), float(agent.value_coef),
                   float(agent.max_grad_norm))

    def f32(self):
        """``(lr, 1 − c, 1 + c, c_v, max_norm, β1, 1 − β1, β2, 1 − β2, ε)``
        as float32; the differences are taken in double first, as the
        reference takes them."""
        return tuple(float(np.float32(v)) for v in (
            self.lr, 1.0 - self.clipping, 1.0 + self.clipping, self.value_coef,
            self.max_norm, self.beta1, 1.0 - self.beta1, self.beta2,
            1.0 - self.beta2, self.eps))


ROW_TILE = 64
HIDDEN_PAD = 128          # hidden widths are zero-padded to this in shared memory
HEADS_PAD = 8             # logits + value, padded
MAX_FINISH_BLOCKS = 1024
_LD = HIDDEN_PAD + 4


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The grad kernel's launch (``make_geo`` in the .cu) on a card with
    ``n_sm`` SMs: ``tiles`` row tiles of ``ROW_TILE``, ``tiles_per_block``
    of them (the stripe) for each of ``grid`` blocks, the gfold partial in
    shared memory or in the block's record, and the scratch the wrapper
    allocates."""
    tiles: int
    tiles_per_block: int
    grid: int
    gf_in_smem: bool
    smem_bytes: int
    record_floats: int
    scratch_floats: int

    def stripe(self, block: int, B: int) -> Tuple[int, int]:
        """Rows ``[row0, row1)`` that grad block ``block`` walks."""
        row0 = min(B, block * self.tiles_per_block * ROW_TILE)
        return row0, min(B, (block + 1) * self.tiles_per_block * ROW_TILE)


def grad_smem_floats() -> int:
    """The grad kernel's shared memory without the gfold buffer: W2, the
    heads and the two 64-row activation tiles (row stride 132), biases, row
    buffers and accumulators."""
    hp, a1p, r = HIDDEN_PAD, HEADS_PAD, ROW_TILE
    return (hp * _LD + a1p * _LD + 2 * hp + a1p + 2 * r * _LD + r * a1p + r + 5 * r
            + (hp * a1p + a1p + 2 * hp + 4))


def check_shapes(S: int, D: int, H1: int, H2: int, A: int, B: int) -> None:
    """Raises ``ValueError`` for shapes the kernel does not take (``supported``
    in the .cu)."""
    if not (1 <= H1 <= HIDDEN_PAD and 1 <= H2 <= HIDDEN_PAD):
        raise ValueError(f"ppo_optimize: hidden widths {H1}x{H2}; the kernel takes at most "
                         f"{HIDDEN_PAD}")
    if not 2 <= A <= HEADS_PAD - 1:
        raise ValueError(f"ppo_optimize: {A} actions; the kernel takes 2 to {HEADS_PAD - 1}")
    if B < 1 or S < 1 or D < 1:
        raise ValueError(f"ppo_optimize: B={B}, S={S}, D={D}")


def geometry(S: int, D: int, H1: int, H2: int, A: int, P: int, B: int,
             n_sm: int) -> Geometry:
    """Launch geometry for these shapes on ``n_sm`` SMs; raises
    ``ValueError`` for shapes the kernel does not take."""
    check_shapes(S, D, H1, H2, A, B)
    if n_sm < 1:
        raise ValueError(f"ppo_optimize: n_sm={n_sm}")
    tiles = -(-B // ROW_TILE)
    tpb = -(-tiles // n_sm)
    grid = -(-tiles // tpb)
    base, gf = 4 * grad_smem_floats(), 4 * S * H1
    if base > SMEM_CAP:
        raise ValueError("ppo_optimize: the grad kernel does not fit in shared memory")
    gf_smem = base + gf <= SMEM_CAP
    record = S * H1 + H1 * H2 + H2 + H2 * A + H2 + A + 1 + H1 + 1
    return Geometry(tiles, tpb, grid, gf_smem, base + (gf if gf_smem else 0), record,
                    2 * S * H1 + P + 4 + MAX_FINISH_BLOCKS + grid * record)


WIDE_MIN_ROWS = 8  # the wide route's smallest row tile (kRB in the .cu)


@dataclasses.dataclass(frozen=True)
class WideGeometry:
    """The wide route's launch (``ppo_wide_geometry`` in the .cu): grad
    blocks of ``rows`` rows each, the gfold partial in shared memory or in
    the block's record; ``smem_bytes`` 0 means the shape is not taken."""
    rows: int
    blocks: int
    gf_in_smem: bool
    smem_bytes: int
    scratch_floats: int


def wide_geometry(S: int, D: int, H1: int, H2: int, A: int, P: int, B: int) -> WideGeometry:
    """The wide route's row tile (64 rows up to width 128, halved while
    ``rows · max(H1, H2)`` exceeds 64 · 128, down to 8), its grad kernel's
    shared memory (``rows · (5 + 2·H1 + 2·H2 + A + 2)`` floats, plus the
    ``[S, H1]`` gfold partial where it fits) and the device scratch."""
    rows, h = ROW_TILE, max(H1, H2)
    while rows > WIDE_MIN_ROWS and rows * h > ROW_TILE * HIDDEN_PAD:
        rows //= 2
    blocks = -(-B // rows)
    smem = 4 * rows * (5 + 2 * H1 + 2 * H2 + (A + 1) + 1)
    gf_smem = smem + 4 * S * H1 <= SMEM_CAP
    if gf_smem:
        smem += 4 * S * H1
    record = S * H1 + H1 * H2 + H2 + H2 * A + H2 + A + 1 + H1 + 1
    return WideGeometry(rows, blocks, gf_smem, smem if smem <= SMEM_CAP else 0,
                        2 * S * H1 + P + 4 + blocks * record)


def route(S: int, D: int, H1: int, H2: int, A: int) -> str:
    """``"persistent"`` for hidden widths up to ``HIDDEN_PAD`` and at most
    ``HEADS_PAD − 1`` actions, else ``"wide"``; raises ``ValueError`` for
    shapes neither takes (fewer than two actions, an empty dimension, or a
    row tile of ``WIDE_MIN_ROWS`` rows that does not fit in shared memory)."""
    if A < 2 or min(S, D, H1, H2) < 1:
        raise ValueError(f"ppo_optimize: A={A}, S={S}, D={D}, hidden {H1}x{H2}")
    if H1 <= HIDDEN_PAD and H2 <= HIDDEN_PAD and A <= HEADS_PAD - 1:
        return "persistent"
    if wide_geometry(S, D, H1, H2, A, 0, 1).smem_bytes == 0:
        raise ValueError(f"ppo_optimize: hidden {H1}x{H2} with {A} actions needs more shared "
                         f"memory per block than {SMEM_CAP} bytes at a row tile of "
                         f"{WIDE_MIN_ROWS}")
    return "wide"


def flat_offsets(agent: PPOAgent) -> Tuple[int, ...]:
    """Offsets of ``OFFSET_NAMES`` in the agent's flat parameter vector."""
    at, offs = 0, {}
    for k in sorted(agent.shapes):
        offs[k] = at
        at += int(np.prod(agent.shapes[k]))
    return tuple(offs[k] for k in OFFSET_NAMES)


def check_agent(agent: PPOAgent) -> None:
    if agent.net_kind != "table" or len(agent.hidden) != 2:
        raise ValueError(
            f"the fused PPO optimize kernel takes the table-folded net with two hidden "
            f"layers, got net={agent.net_kind!r}, hidden={agent.hidden}")


def ppo_optimize_reference(agent: PPOAgent, flat, mu, nu, count, ce, streams):
    """Plain PyTorch version of the kernel: U autograd steps of the agent's
    loss with the global-norm clip and Adam."""
    counts.plain_calls += 1
    sidx, act, olp, adv, ret = streams
    losses = []
    for u in range(sidx.shape[0]):
        batch = {"states": TableState(idx=sidx[u], t=torch.zeros_like(sidx[u])),
                 "actions": act[u], "old_logp": olp[u], "advantages": adv[u],
                 "returns": ret[u]}
        flat, mu, nu, loss = agent.update(flat, mu, nu, count + u, batch, ce.reshape(()))
        losses.append(loss)
    return flat, mu, nu, count + sidx.shape[0], torch.stack(losses).mean().reshape(1)


def bind(lib: ctypes.CDLL):
    """The launch entry point of a build of ``csrc/ppo_kernel.cu`` (this
    package's, or a traced one), with its argument types set."""
    fn = lib.ppo_optimize_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] + [I] * 5 + [ctypes.POINTER(I), I, P, P, P] + [P] * 5 + [I] * 2
                       + [F] * 10 + [I] + [P] * 3 + [P])
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return bind(build("ppo_kernel")["ppo_kernel"])


def bind_wide(lib: ctypes.CDLL):
    """The launch entry point of a build of ``csrc/ppo_wide_kernel.cu``."""
    fn = lib.ppo_wide_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] + [I] * 5 + [ctypes.POINTER(I), I, P, P, P] + [P] * 5 + [I] * 2
                       + [F] * 10 + [P] * 3 + [P])
        fn.restype = ctypes.c_int
    return fn


def _wide_lib():
    return bind_wide(build("ppo_wide_kernel")["ppo_wide_kernel"])


def kernel_wide_geometry(S: int, D: int, H1: int, H2: int, A: int, P: int, B: int) -> tuple:
    """``(rows, blocks, gfold in shared memory, shared-memory bytes, scratch
    floats)`` as the built wide kernel computes them; needs nvcc, so only on
    a card host, where it is held against ``wide_geometry``."""
    fn = build("ppo_wide_kernel")["ppo_wide_kernel"].ppo_wide_geometry
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 5)()
    fn(S, D, H1, H2, A, P, B, ctypes.addressof(out))
    return tuple(int(x) for x in out)


def kernel_geometry(S: int, D: int, H1: int, H2: int, A: int, P: int, B: int,
                    n_sm: int) -> tuple:
    """``(tiles, tiles per block, grid, gfold in shared memory, shared-memory
    bytes, scratch floats)`` as the built kernel computes them (all 0: not
    taken); needs nvcc, so only on a card host, where it is held against
    ``geometry``."""
    fn = build("ppo_kernel")["ppo_kernel"].ppo_optimize_geometry
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 6)()
    fn(S, D, H1, H2, A, P, B, n_sm, ctypes.addressof(out))
    return tuple(int(x) for x in out)


def ppo_optimize(agent: PPOAgent, flat, mu, nu, count, ce, streams):
    """U fused PPO updates of ``agent``'s table-folded net.

    ``flat``, ``mu``, ``nu`` are ``[P]`` f32 (ravel order), ``count`` a
    ``(1,)`` int64 Adam step count, ``ce`` a ``(1,)`` f32 entropy
    coefficient and ``streams`` the five ``[U, B]`` minibatch streams.
    Returns ``(flat, mu, nu, count, loss)`` with ``count`` and ``loss`` of
    shape ``(1,)``. CUDA tensors launch the kernel of ``route``'s choice;
    CPU tensors run ``ppo_optimize_reference``. Shapes neither route takes
    raise ``ValueError`` before the launch."""
    check_agent(agent)
    if len(streams) != 5 or streams[0].dim() != 2:
        raise ValueError("streams: expected five [U, B] tensors")
    U, B = streams[0].shape
    dev = flat.device
    obs = agent.obs_flat
    S, D = obs.shape
    H1, H2 = agent.hidden
    A = agent.env.n_actions
    P = flat.numel()
    check_tensor(obs, torch.float32, (S, D), dev, "obs")
    for name, t in (("flat", flat), ("mu", mu), ("nu", nu)):
        check_tensor(t, torch.float32, (P,), dev, name)
    check_tensor(count, torch.int64, (1,), dev, "count")
    check_tensor(ce, torch.float32, (1,), dev, "ce")
    for name, t, dtype in zip(("sidx", "action", "old_logp", "advantage", "return"),
                              streams, STREAM_DTYPES):
        check_tensor(t, dtype, (U, B), dev, name)
    if dev.type == "cpu":
        return ppo_optimize_reference(agent, flat, mu, nu, count, ce, streams)
    if dev.type != "cuda":
        raise ValueError(f"ppo_optimize: unsupported device {dev}")
    hyper = OptHyper.from_agent(agent)
    if B < 1:
        raise ValueError(f"ppo_optimize: B={B}")
    persistent = route(S, D, H1, H2, A) == "persistent"  # raises for shapes neither takes
    if persistent:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        scratch_floats, extra = geometry(S, D, H1, H2, A, P, B, n_sm).scratch_floats, (n_sm,)
        fn = _lib()
    else:
        scratch_floats, extra = wide_geometry(S, D, H1, H2, A, P, B).scratch_floats, ()
        fn = _wide_lib()
    offs = (ctypes.c_int * 8)(*flat_offsets(agent))
    state = torch.cat([flat, mu, nu])
    scratch = torch.empty(scratch_floats, dtype=torch.float32, device=dev)
    count_o = torch.empty((1,), dtype=torch.int64, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    with current_device(dev):
        err = fn(obs.data_ptr(), S, D, H1, H2, A, offs, P, state.data_ptr(),
                 count.data_ptr(), ce.data_ptr(), *(t.data_ptr() for t in streams), U, B,
                 *hyper.f32(), *extra, scratch.data_ptr(), count_o.data_ptr(),
                 loss.data_ptr(), stream_of(dev))
    check(err, "ppo_optimize_launch" if persistent else "ppo_wide_launch")
    (counts if persistent else wide_counts).launches += 1
    return state[:P], state[P:2 * P], state[2 * P:], count_o, loss
