"""Pipeline parallelism over a ``stage`` axis: the GPipe schedule demo.

Counterpart of ``safe_grid_agents_tpu/parallel/pp.py``. Gridworld nets
have nothing to cut into stages; like the reference, this module shows the
runtime can: stage-sharded parameters (each rank of a ``stage`` group owns
one stage's weights and never moves them), a GPipe microbatch schedule
built from ring shifts (``collectives.ring_shift``, the reference's
``ppermute``), and autograd through the schedule, so that a training
step's gradients stay stage-local. It is held to the sequential program.

The schedule runs M + S − 1 ticks: stage 0 injects microbatch ``t`` at tick
``t``, stage ``S−1`` emits microbatch ``t−(S−1)`` at tick ``t``, and each
tick sends one activation to the next stage. Backward needs no schedule of
its own: the ring shift's backward is the inverse shift, so autograd
through the forward ticks is the reverse pipeline. Every rank builds the
same graph (the stage's role enters as a tensor mask, not a branch), so the
ranks' backward passes make their shifts in the same order.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .collectives import reduce_from_model, ring_shift
from .mesh import AxisGroup, make_1d_mesh

STAGE_AXIS = "stage"
Params = Dict[str, torch.Tensor]


def make_pp_mesh(n_stages: int, device=None) -> AxisGroup:
    return make_1d_mesh(STAGE_AXIS, n_stages, device)


def init_pp_params(seed: int, n_stages: int, d_model: int,
                   layers_per_stage: int = 1) -> Params:
    """Stage-stacked residual-MLP params (CPU, from a generator seeded
    ``seed``): leaves lead with the stage axis; stage ``s`` applies
    ``layers_per_stage`` blocks of ``x + tanh(x @ w + b)``."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((n_stages, layers_per_stage, d_model, d_model), generator=g)
    return {"w": w / torch.sqrt(torch.tensor(float(d_model))),
            "b": torch.zeros((n_stages, layers_per_stage, d_model))}


def _stage_block(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One stage's residual blocks: ``w`` ``[L, d, d]``, ``b`` ``[L, d]``."""
    for i in range(w.shape[0]):
        x = x + torch.tanh(x @ w[i] + b[i])
    return x


def sequential_apply(params: Params, xs: torch.Tensor) -> torch.Tensor:
    """Ground truth: every stage in order on all microbatches at once.
    ``params`` leaves ``[S, L, ...]``; ``xs`` ``[M, mb, d]``."""
    for s in range(params["w"].shape[0]):
        xs = _stage_block(params["w"][s], params["b"][s], xs)
    return xs


def pipeline_apply(group: AxisGroup, params: Params, xs: torch.Tensor) -> torch.Tensor:
    """GPipe forward over the ``stage`` group. ``params``: this rank's stage
    (``place_pp``, leaves ``[1, L, ...]``); ``xs`` ``[M, mb, d]``
    microbatches (replicated). Returns ``[M, mb, d]``, replicated (the last
    stage's outputs summed over the group, whose backward hands every stage
    the same gradient). Every rank of the group calls it."""
    S, M = group.world_size, xs.shape[0]
    w, b = params["w"][0], params["b"][0]
    first = torch.tensor(group.rank == 0, device=xs.device)
    act = torch.zeros_like(xs[0])
    outs = []
    for t in range(M + S - 1):
        # Ticks past M feed the bubble; their results are not read.
        x_in = torch.where(first, xs[min(t, M - 1)], act)
        out = _stage_block(w, b, x_in)
        outs.append(out)
        if t < M + S - 2:  # the last tick's activation has no next tick
            act = ring_shift(out, group)
    # Microbatch m leaves the last stage at tick m + S − 1.
    ys = torch.stack(outs[S - 1:S - 1 + M])
    last = float(group.rank == S - 1)
    return reduce_from_model(ys * last, group)


def place_pp(group: AxisGroup, params: Params) -> Params:
    """This rank's stage of stage-stacked params (``[1, L, ...]``, on the
    group's device): each stage's weights live only on its rank."""
    r = group.rank
    return {k: v[r:r + 1].to(group.device, copy=True) for k, v in params.items()}


def pp_train_step(group: AxisGroup, params: Params, xs: torch.Tensor, targets: torch.Tensor,
                  lr: float) -> Tuple[Params, torch.Tensor]:
    """One SGD step of the pipelined model on an MSE objective. Each rank
    computes its stage's gradient and update; nothing but activations (and
    their gradients) crosses ranks."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = torch.square(pipeline_apply(group, leaves, xs) - targets).mean()
    grads = torch.autograd.grad(loss, [leaves[k] for k in leaves])
    new = {k: (v - lr * g).detach() for (k, v), g in zip(leaves.items(), grads)}
    return new, loss.detach()
