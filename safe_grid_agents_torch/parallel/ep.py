"""Expert parallelism over an ``expert`` axis: the all-to-all MoE demo.

Counterpart of ``safe_grid_agents_tpu/parallel/ep.py``. Gridworld nets have
no experts to shard; like the reference, this module shows the runtime
can: a mixture-of-experts layer with one expert's weights a rank, top-1
routing with a fixed capacity per (source, expert) pair, and the dispatch
→ ``all_to_all`` → expert → ``all_to_all`` → combine path
(``collectives.all_to_all``, differentiable: backward runs the reverse
exchange and each expert's gradient stays on its rank). It is held to the
dense program that runs every expert on every token.

Tokens shard over the same axis the experts live on; the exchanges move
only the dispatched token buffers (``[E, C, d]`` each way), never the
weights. Shapes are fixed: a token past its pair's capacity ``C`` passes
through the residual path unchanged (the usual MoE drop; ``C ≥ b`` is
exact against the dense program).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .collectives import all_to_all, psum
from .mesh import AxisGroup, make_1d_mesh

EXPERT_AXIS = "expert"
Params = Dict[str, torch.Tensor]


def make_ep_mesh(n_experts: int, device=None) -> AxisGroup:
    return make_1d_mesh(EXPERT_AXIS, n_experts, device)


def init_moe_params(seed: int, n_experts: int, d_model: int, d_hidden: int) -> Params:
    """Router (replicated) and expert-stacked FFN weights (leading axis the
    expert), on the CPU from a generator seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    s1 = 1.0 / float(d_model) ** 0.5
    s2 = 1.0 / float(d_hidden) ** 0.5
    return {"router": torch.randn((d_model, n_experts), generator=g) * s1,
            "w_in": torch.randn((n_experts, d_model, d_hidden), generator=g) * s1,
            "w_out": torch.randn((n_experts, d_hidden, d_model), generator=g) * s2}


def _expert_ffn(w_in: torch.Tensor, w_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ w_in) @ w_out


def dense_moe_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Ground truth: EVERY expert on every token, the routed output kept.
    ``x`` ``[B, d]`` → ``[B, d]``."""
    e = torch.argmax(x @ params["router"], -1)                      # [B]
    all_out = torch.stack([_expert_ffn(params["w_in"][i], params["w_out"][i], x)
                           for i in range(params["w_in"].shape[0])])  # [E, B, d]
    return all_out[e, torch.arange(x.shape[0], device=x.device)] + x


def ep_moe_apply(group: AxisGroup, params: Params, xs: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """Expert-parallel MoE forward on this rank's tokens ``xs`` ``[1, b, d]``
    with its expert (``place_ep``: ``w_in`` ``[1, d, H]``, ``w_out`` ``[1,
    H, d]``, the router whole); returns ``[1, b, d]``. ``capacity`` is the
    most tokens one source rank sends one expert; the rest pass through the
    residual path unchanged. Every rank of the group calls it."""
    E = group.world_size
    x = xs[0]
    b, d = x.shape
    e = torch.argmax(x @ params["router"], -1)                      # destination expert
    # Token i takes slot (e[i], its rank among the tokens bound for e[i]);
    # ranks past the capacity are dropped.
    onehot = torch.nn.functional.one_hot(e, E)
    pos = ((torch.cumsum(onehot, 0) * onehot).sum(-1) - 1)          # [b]
    keep = pos < capacity
    slot = (e * capacity + pos)[keep]
    send = torch.zeros((E * capacity, d), dtype=x.dtype, device=x.device)
    send = send.index_add(0, slot, x[keep]).view(E, capacity, d)
    recv = all_to_all(send, group)              # row k: what source k sent here
    out = _expert_ffn(params["w_in"][0], params["w_out"][0], recv.reshape(-1, d))
    back = all_to_all(out.view(E, capacity, d), group).reshape(E * capacity, d)
    # Combine: token i reads its slot back from its expert's return.
    y = torch.zeros_like(x).index_copy(0, keep.nonzero().squeeze(-1), back[slot])
    return (x + y)[None]


def place_ep(group: AxisGroup, params: Params) -> Params:
    """The router whole, this rank's expert (``[1, ...]``), on its device."""
    r = group.rank
    return {"router": params["router"].to(group.device, copy=True),
            "w_in": params["w_in"][r:r + 1].to(group.device, copy=True),
            "w_out": params["w_out"][r:r + 1].to(group.device, copy=True)}


def ep_train_step(group: AxisGroup, params: Params, xs: torch.Tensor, targets: torch.Tensor,
                  capacity: int, lr: float) -> Tuple[Params, torch.Tensor]:
    """One SGD step on the MSE over every rank's tokens through the
    expert-parallel layer: the backward exchange returns each expert's
    gradient to its rank; the router's (replicated) gradient is summed over
    the ranks. Returns ``(params, loss)``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    n = xs.numel() * group.world_size
    local = torch.square(ep_moe_apply(group, leaves, xs, capacity) - targets).sum() / n
    grads = torch.autograd.grad(local, [leaves[k] for k in leaves], allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    grads["router"] = psum(grads["router"], group)
    new = {k: (v - lr * grads[k]).detach() for k, v in leaves.items()}
    return new, psum(local.detach(), group)
