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
from ._build import build, check
from .rollout_kernel import SMEM_CAP, check_tensor

counts = LaunchCounts()

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


def smem_bytes(B: int, H1: int, H2: int, A: int, with_activations: bool) -> int:
    """Dynamic shared memory of one launch (``dqn_update_smem`` in the .cu)."""
    words = B * (5 + 3 * A + 2)
    if with_activations:
        words += 3 * B * max(H1, H2)
    return 4 * words


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


def _lib():
    lib = build("dqn_update_kernel")["dqn_update_kernel"]
    fn = lib.dqn_update_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] + [I] * 4 + [P] * 8 + [I] * 2 + [F] * 7 + [I] * 2
                       + [P] * 5)
        fn.restype = ctypes.c_int
    return fn


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
    shape ``(1,)``. CUDA tensors launch the kernel; CPU tensors run
    ``dqn_update_reference``."""
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
    fn = _lib()
    state = torch.cat([d[k].reshape(-1) for d in (params, target, mu, nu) for k in NAMES])
    scratch = None
    if smem_bytes(B, H1, H2, A, True) > SMEM_CAP:
        if smem_bytes(B, H1, H2, A, False) > SMEM_CAP:
            raise ValueError(f"batch size {B} needs more shared memory than a block has")
        scratch = torch.empty(3 * B * max(H1, H2), dtype=torch.float32, device=dev)
    count_o = torch.empty((1,), dtype=torch.int64, device=dev)
    upd_o = torch.empty((1,), dtype=torch.int64, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            obs.data_ptr(), D, H1, H2, A, state.data_ptr(), count.data_ptr(),
            updates.data_ptr(), batch.s_idx.data_ptr(), batch.n_idx.data_ptr(),
            batch.action.data_ptr(), batch.reward.data_ptr(), batch.done.data_ptr(),
            U, B, *hyper.f32(), hyper.sync_every, int(hyper.double_q),
            0 if scratch is None else scratch.data_ptr(),
            count_o.data_ptr(), upd_o.data_ptr(), loss.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "dqn_update_launch")
    counts.launches += 1
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
