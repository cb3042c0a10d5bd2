"""Fused DQN update: U sampled TD updates in one CUDA kernel launch.

Counterpart of ``safe_grid_agents_tpu/ops/dqn_update_kernel.py`` (kernel B4
of ROADMAP queue B). ``dqn_update`` launches ``csrc/dqn_update_kernel.cu``
for CUDA tensors; ``dqn_update_reference`` is the plain PyTorch version it
is held against, and the one ``dqn_update`` runs for CPU tensors. The plain
version differentiates the agent's own ``td_loss`` with ``torch.autograd``
and applies Adam as written out here, so the kernel's hand-derived backward
is held against autograd.

Per update u of a chunk: the online net on the batch's states, the target
net on its next states (and, with double-Q, the online net there too, to
pick a* by first max), the Huber TD loss with γⁿ bootstrap masked by done,
its gradient, Adam (``optax.adam``: β 0.9 / 0.999, ε 1e-8, no clip), and a
target sync when ``(updates0 + u + 1) % sync_every == 0``. The loss is the
mean over U of each update's batch-mean loss. The batch is presampled by
the caller (``[U, B]`` records gathered from the ring).

Two routes, both hand-written kernels, chosen by ``route`` from the shape
alone before the launch:

* ``cluster`` (``csrc/dqn_update_kernel.cu``): the U updates on one
  thread-block cluster; block r of the cluster owns a column slice of each
  hidden layer (and the head's matching rows) of all four parameter sets,
  which stay in shared memory for the whole launch. ``geometry`` mirrors the
  kernel's choice of cluster size and row tile and its shared-memory sizing.
* ``grid`` (``csrc/dqn_update_grid.cu``): the U updates in one cooperative
  launch over every SM, phase by phase with grid barriers between, each
  product cut into tiles on the tensor cores (``csrc/tile_gemm.cuh``) and
  the parameter sets in device memory (L2-resident), for nets or batches
  whose slices do not fit 16 blocks (e.g. hidden 512, or B = 4096 at width
  128). ``grid_geometry`` mirrors its grid, products, split-K parts and
  scratch.

``counts`` counts the cluster route's launches (and the plain version's
calls), ``grid_counts`` the grid route's. A failed build or launch raises;
neither route falls back to the other or to the plain version.

Scope: two-hidden-layer ReLU nets (table-folded or plain MLP: both compute
``relu(O[idx] @ w1 + b1)`` and agree to rounding); uniform replay.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from . import LaunchCounts
from . import tile_gemm as tg
from ._build import build, check, current_device, stream_of
from .rollout_kernel import SMEM_CAP, check_tensor

counts = LaunchCounts()       # the cluster route, and the plain version's calls
grid_counts = LaunchCounts()  # the grid route

NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")
BATCH_DTYPES = dict(s_idx=torch.int32, n_idx=torch.int32, action=torch.int32,
                    reward=torch.float32, done=torch.bool)


@dataclasses.dataclass(frozen=True)
class UpdateHyper:
    lr: float
    gamma_n: float      # discount ** n_step
    sync_every: int
    double_q: bool
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    @classmethod
    def from_agent(cls, agent) -> "UpdateHyper":
        return cls(float(agent.lr), float(agent.discount ** agent.n_step),
                   int(agent.sync_every), bool(agent.double_q))

    def f32(self):
        """``(lr, γⁿ, β1, 1 − β1, β2, 1 − β2, ε)`` as float32; ``1 − β`` is
        taken in double first, as optax computes it."""
        return tuple(float(np.float32(v)) for v in (
            self.lr, self.gamma_n, self.beta1, 1.0 - self.beta1,
            self.beta2, 1.0 - self.beta2, self.eps))


CLUSTER_SIZES = (8, 16)
# (cluster size, rows per row tile) in the kernel's order of preference.
GEOMETRY_ORDER = ((8, 128), (8, 64), (16, 128), (16, 64), (8, 32), (16, 32), (8, 16),
                  (16, 16), (8, 8), (16, 8))


def _r4(x: int) -> int:
    return (x + 3) & ~3


def _r8(x: int) -> int:
    return (x + 7) & ~7


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch's geometry (``make_geo`` / ``choose_geo`` in the .cu): a
    cluster of ``cluster`` blocks, block r owning layer-1 units
    ``[r·c1, min(H1, (r+1)·c1))`` and layer-2 units ``[r·c2, ...)``, the batch
    walked in row tiles of ``row_tile`` rows."""
    cluster: int
    row_tile: int
    c1: int
    c2: int
    smem_bytes: int

    def owned(self, rank: int, H1: int, H2: int):
        """``((j0, n1), (k0, n2))``: block ``rank``'s first unit and unit
        count in each hidden layer (a count may be 0 on a ragged edge)."""
        j0, k0 = min(rank * self.c1, H1), min(rank * self.c2, H2)
        return (j0, min(H1, j0 + self.c1) - j0), (k0, min(H2, k0 + self.c2) - k0)


def make_geometry(D: int, H1: int, H2: int, A: int, B: int, C: int, RB: int) -> Geometry:
    """Shared memory of one block for cluster size ``C`` and row tile
    ``RB``: the four parameter sets' slices (w1 and w2 columns, the head's
    rows; strides padded to 16 bytes, w2's away from a multiple of 8 floats),
    the batch, the head partials of three passes, two x1 slices, the x2
    slice, the gradient accumulators and one row tile of width
    ``r8(max(D, H1)) + 4``."""
    c1, c2 = -(-H1 // C), -(-H2 // C)
    ld1, ld2a = _r4(c1), _r4(c2)
    ld2p = ld2a if ld2a % 8 else ld2a + 4
    ldx = _r8(max(D, H1)) + 4
    ps = D * ld1 + ld1 + H1 * ld2p + ld2a + _r4(c2 * A) + _r4(A)
    gacc = max(D * ld1, H1 * ld2a, _r4(c2 * A + A))
    floats = (4 * ps + 5 * _r4(B) + 3 * _r4(B * A) + 2 * _r4(B) + 2 * B * ld1 + B * ld2a
              + gacc + RB * ldx)
    return Geometry(C, RB, c1, c2, 4 * floats)


def geometry(D: int, H1: int, H2: int, A: int, B: int) -> Geometry:
    """The first geometry of ``GEOMETRY_ORDER`` whose block fits in shared
    memory; raises ``ValueError`` if none does."""
    for C, RB in GEOMETRY_ORDER:
        g = make_geometry(D, H1, H2, A, B, C, min(RB, _r8(B)))
        if g.smem_bytes <= SMEM_CAP:
            return g
    raise ValueError(
        f"dqn_update: D={D}, hidden {H1}x{H2}, A={A}, B={B} needs more shared memory per "
        f"block than {SMEM_CAP} bytes at every cluster size {CLUSTER_SIZES} and row tile")


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """One launch of the grid route (``dqn_update_grid_geometry`` in the
    .cu): ``grid`` co-resident blocks of ``tg.SMEM_BYTES`` shared memory,
    the products of each phase of an update (layer 1 and layer 2 of each
    pass: the online net on s, the target net on s', with double-Q the
    online net on s'; then ∂x1 and the head's and layer 2's gradients; then
    layer 1's gradient) and the device scratch the wrapper allocates."""
    grid: int
    smem_bytes: int
    scratch_floats: int
    phases: Tuple[Tuple[tg.Job, ...], ...]

    def report(self) -> tuple:
        """The kernel's own report: grid, shared memory, scratch, jobs,
        then each job's M, N, K and parts."""
        jobs = [j for phase in self.phases for j in phase]
        return (self.grid, self.smem_bytes, self.scratch_floats, len(jobs),
                *(x for j in jobs for x in j.report()))


def grid_geometry(D: int, H1: int, H2: int, A: int, B: int, double_q: bool,
                  n_sm: int) -> GridGeometry:
    """The grid route's launch for these shapes on a card of ``n_sm`` SMs.
    Scratch: the passes' activations x1 ``[R, H1]`` and x2 ``[R, H2]`` (R = 2B,
    or 3B with double-Q), the head derivative ``[B, A]``, the Huber losses
    ``[B]``, ∂x2 ``[B, H2]`` and ∂x1 ``[B, H1]``, the split-K parts of the
    three gradient products (each with a bias row) and the running loss,
    each buffer from a 16-byte boundary."""
    passes = 3 if double_q else 2
    J = tg.Job.make
    phases = (tuple(J(B, H1, D, False) for _ in range(passes)),
              tuple(J(B, H2, H1, False) for _ in range(passes)),
              (J(B, H1, H2, False), J(H2 + 1, A, B, True), J(H1 + 1, H2, B, True)),
              (J(D + 1, H1, B, True),))
    parts = tg.parts(B)
    scratch = tg.scratch(passes * B * H1, passes * B * H2, B * A, B, B * H2, B * H1,
                         parts * (H2 + 1) * A, parts * (H1 + 1) * H2, parts * (D + 1) * H1, 1)
    return GridGeometry(tg.grid(n_sm), tg.SMEM_BYTES, scratch, phases)


def route(D: int, H1: int, H2: int, A: int, B: int) -> str:
    """``"cluster"`` where ``geometry`` finds a cluster that holds the net
    and the batch, else ``"grid"``; raises ``ValueError`` for nets whose
    parameter sets overflow the kernels' 32-bit element counts."""
    try:
        geometry(D, H1, H2, A, B)
        return "cluster"
    except ValueError:
        pass
    P = D * H1 + H1 + H1 * H2 + H2 + H2 * A + A
    if 4 * P >= 2 ** 31:
        raise ValueError(f"dqn_update: D={D}, hidden {H1}x{H2}, A={A}: the four parameter "
                         "sets overflow the grid kernel's 32-bit element counts")
    return "grid"


def adam_reference(p, m, v, g, t, hyper: UpdateHyper):
    """One ``optax.adam`` step of one tensor in its arithmetic order;
    ``t`` is the f32 step count after the increment."""
    lr, _, b1, omb1, b2, omb2, eps = hyper.f32()
    m = omb1 * g + b1 * m
    v = omb2 * (g * g) + b2 * v
    dev = p.device
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** t
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** t
    p = p + (-lr) * ((m / c1) / (torch.sqrt(v / c2) + eps))
    return p, m, v


def dqn_update_reference(agent, params, target, mu, nu, count, updates, batch):
    """Plain PyTorch version of the kernel: U autograd steps of the agent's
    ``td_loss`` with Adam and the scheduled target sync."""
    counts.plain_calls += 1
    hyper = UpdateHyper.from_agent(agent)
    U = batch.action.shape[0]
    params, target, mu, nu = ({k: d[k] for k in NAMES} for d in (params, target, mu, nu))
    losses = []
    for u in range(U):
        rows = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name)[u] for f in dataclasses.fields(batch)})
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = agent.td_loss(leaves, target, rows)
        grads = torch.autograd.grad(loss, [leaves[k] for k in NAMES])
        t = (count + u + 1).to(torch.float32)
        new_p, new_m, new_v = {}, {}, {}
        for k, g in zip(NAMES, grads):
            new_p[k], new_m[k], new_v[k] = adam_reference(params[k], mu[k], nu[k], g, t, hyper)
        params, mu, nu = new_p, new_m, new_v
        sync = (updates + u + 1) % hyper.sync_every == 0
        target = {k: torch.where(sync, params[k], target[k]) for k in NAMES}
        losses.append(loss.detach())
    loss = torch.stack(losses).mean().reshape(1)
    return params, target, mu, nu, count + U, updates + U, loss


def bind(lib: ctypes.CDLL):
    """The launch entry point of a build of ``csrc/dqn_update_kernel.cu``
    (this package's, or a traced one), with its argument types set."""
    fn = lib.dqn_update_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] + [I] * 4 + [P] * 8 + [I] * 2 + [F] * 7 + [I] * 2
                       + [P] * 4)
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return bind(build("dqn_update_kernel")["dqn_update_kernel"])


def bind_grid(lib: ctypes.CDLL):
    """The launch entry point of a build of ``csrc/dqn_update_grid.cu``
    (this package's, or a traced one)."""
    fn = lib.dqn_update_grid_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] + [I] * 4 + [P] * 8 + [I] * 2 + [F] * 7 + [I] * 2
                       + [P] * 5)
        fn.restype = ctypes.c_int
    return fn


def _grid_lib():
    return bind_grid(build("dqn_update_grid")["dqn_update_grid"])


def kernel_grid_geometry(D: int, H1: int, H2: int, A: int, B: int, double_q: bool,
                         n_sm: int) -> tuple:
    """``grid_geometry(...).report()`` as the built grid kernel computes
    it; needs nvcc, so only on a card host."""
    fn = build("dqn_update_grid")["dqn_update_grid"].dqn_update_grid_geometry
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 44)()
    fn(D, H1, H2, A, B, int(double_q), n_sm, ctypes.addressof(out))
    return tuple(int(x) for x in out[:4 + 4 * out[3]])


def kernel_geometry(D: int, H1: int, H2: int, A: int, B: int) -> tuple:
    """``(cluster size, row tile, shared-memory bytes)`` as the built kernel
    computes them (cluster size 0: none fits); needs nvcc, so only on a card
    host, where it is held against ``geometry``."""
    lib = build("dqn_update_kernel")["dqn_update_kernel"]
    fn = lib.dqn_update_geometry
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 3)()
    fn(D, H1, H2, A, B, ctypes.addressof(out))
    return tuple(int(x) for x in out)


def _check_params(sets, D: int, H1: int, H2: int, A: int, dev) -> None:
    shapes = dict(w1=(D, H1), b1=(H1,), w2=(H1, H2), b2=(H2,), w3=(H2, A), b3=(A,))
    for label, d in sets:
        if sorted(d) != sorted(NAMES):
            raise ValueError(f"{label}: expected tensors {NAMES}, got {sorted(d)} "
                             "(the kernel takes two hidden layers)")
        for k in NAMES:
            check_tensor(d[k], torch.float32, shapes[k], dev, f"{label}.{k}")


def dqn_update(agent, params: Dict[str, torch.Tensor], target, mu, nu,
               count: torch.Tensor, updates: torch.Tensor, batch) -> Tuple:
    """U fused TD updates of ``agent``'s two-hidden-layer Q-net.

    ``params``/``target``/``mu``/``nu`` are ``{w1, b1, w2, b2, w3, b3}``
    dicts (flax layout, ``networks.param_shapes``), ``count`` and
    ``updates`` ``(1,)`` int64 counters (Adam steps, gradient updates) and
    ``batch`` a ``replay.Transition`` whose leaves are ``[U, B]``. Returns
    ``(params, target, mu, nu, count, updates, loss)`` with ``loss`` of
    shape ``(1,)``. CUDA tensors launch the kernel of ``route``'s choice;
    CPU tensors run ``dqn_update_reference``. Shapes neither route takes
    raise ``ValueError`` before the launch."""
    if batch.action.dim() != 2:
        raise ValueError(f"batch: expected [U, B] leaves, got {tuple(batch.action.shape)}")
    U, B = batch.action.shape
    dev = batch.action.device
    obs = agent.obs_flat
    S, D = obs.shape
    w1, w2, w3 = params.get("w1"), params.get("w2"), params.get("w3")
    if w1 is None or w2 is None or w3 is None:
        raise ValueError("dqn_update takes a two-hidden-layer net (w1, w2, w3)")
    H1, H2, A = w1.shape[1], w2.shape[1], w3.shape[1]
    _check_params((("params", params), ("target", target), ("mu", mu), ("nu", nu)),
                  D, H1, H2, A, dev)
    check_tensor(obs, torch.float32, (S, D), dev, "obs")
    check_tensor(count, torch.int64, (1,), dev, "count")
    check_tensor(updates, torch.int64, (1,), dev, "updates")
    for name, dtype in BATCH_DTYPES.items():
        check_tensor(getattr(batch, name), dtype, (U, B), dev, f"batch.{name}")
    if dev.type == "cpu":
        return dqn_update_reference(agent, params, target, mu, nu, count, updates, batch)
    if dev.type != "cuda":
        raise ValueError(f"dqn_update: unsupported device {dev}")
    hyper = UpdateHyper.from_agent(agent)
    if hyper.sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {hyper.sync_every}")
    cluster = route(D, H1, H2, A, B) == "cluster"  # raises for shapes neither takes
    fn = _lib() if cluster else _grid_lib()
    state = torch.cat([d[k].reshape(-1) for d in (params, target, mu, nu) for k in NAMES])
    count_o = torch.empty((1,), dtype=torch.int64, device=dev)
    upd_o = torch.empty((1,), dtype=torch.int64, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    extra, scratch = (), None
    if not cluster:  # the grid route takes a device scratch
        floats = grid_geometry(D, H1, H2, A, B, hyper.double_q, 1).scratch_floats
        scratch = torch.empty(floats, dtype=torch.float32, device=dev)
        extra = (scratch.data_ptr(),)
    with current_device(dev):
        err = fn(
            obs.data_ptr(), D, H1, H2, A, state.data_ptr(), count.data_ptr(),
            updates.data_ptr(), batch.s_idx.data_ptr(), batch.n_idx.data_ptr(),
            batch.action.data_ptr(), batch.reward.data_ptr(), batch.done.data_ptr(),
            U, B, *hyper.f32(), hyper.sync_every, int(hyper.double_q), *extra,
            count_o.data_ptr(), upd_o.data_ptr(), loss.data_ptr(),
            stream_of(dev),
        )
    check(err, "dqn_update_launch" if cluster else "dqn_update_grid_launch")
    (counts if cluster else grid_counts).launches += 1
    sizes = [D * H1, H1, H1 * H2, H2, H2 * A, A]
    shapes = [(D, H1), (H1,), (H1, H2), (H2,), (H2, A), (A,)]
    out, at = [], 0
    for _ in range(4):
        d = {}
        for k, n, shape in zip(NAMES, sizes, shapes):
            d[k] = state[at:at + n].view(shape)
            at += n
        out.append(d)
    return (*out, count_o, upd_o, loss)
