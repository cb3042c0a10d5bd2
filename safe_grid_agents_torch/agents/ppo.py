"""PPO agent: actor-critic nets, the clipped-surrogate loss and its optimizer.

Counterpart of ``safe_grid_agents_tpu/agents/ppo.py::PPOAgent`` (and its
``PPOCNNAgent``) for the MLP, table-folded, fused-kernel and convolutional
nets (``net`` in ``mlp``, ``table``, ``pallas``, ``cnn``). The MLP, fused
and CNN nets run on any env (they read the ``[P, H, W]`` planes, which a
compiled env renders by its observation-table gather), the table-folded
net on a compiled env. The CNN's trunk width is ``hidden[0]``.

The optimizer is ``optax.chain(clip_by_global_norm(max_grad_norm),
adam(lr))`` over the flattened parameters (the reference's base optimizer,
``agents/ppo.py:90-92``, and its MXU trainer's fast mode; clipping by the
global norm and Adam are both the same on the pytree and on the flat
vector), written out as tensors: the flat
vector concatenates the parameters in sorted-name order, which is
``ravel_pytree``'s leaf order, so the Adam moments cross to and from the
JAX package as they are (``convert.py``). The learner state is plain
tensors; its step and Adam counters are int64 (the JAX reference's
``PPOState.step`` is int32 and wraps past 2³¹ env steps; ROADMAP C).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..device import resolve_device
from ..envs.compiled import CompiledEnv, TableState
from ..parallel.collectives import pmean_flat
from .base import Agent, f32, linear_epsilon, obs_dim
from .networks import ActorCriticCNN, ActorCriticMLP, TableActorCritic

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class PPOState:
    params: Params
    mu: torch.Tensor     # [P] f32 — Adam first moments over the flat params
    nu: torch.Tensor     # [P] f32 — Adam second moments
    count: torch.Tensor  # 0-d i64 — Adam steps taken
    step: torch.Tensor   # 0-d i64 — env steps seen (drives the entropy anneal)


def ravel(params: Params) -> torch.Tensor:
    """The parameters as one flat vector, in sorted-name order."""
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def unravel(flat: torch.Tensor, shapes: Dict[str, tuple]) -> Params:
    """Inverse of ``ravel`` for parameters of ``shapes`` (views of ``flat``)."""
    out, at = {}, 0
    for k in sorted(shapes):
        n = 1
        for d in shapes[k]:
            n *= d
        out[k] = flat[at:at + n].view(shapes[k])
        at += n
    if at != flat.numel():
        raise ValueError(f"flat vector has {flat.numel()} values, the net {at}")
    return out


def clip_adam(p, mu, nu, g, t, lr: float, max_norm: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, sq_norm=None):
    """One ``optax.chain(clip_by_global_norm, adam)`` step of flat ``p``
    with gradient ``g``; ``t`` is the f32 Adam step after the increment.
    ``sq_norm``: the squared global norm where ``g`` is one rank's shard of
    the gradient (``parallel/tp.py``), else Σ g². Returns ``(p, mu, nu)``."""
    dev = p.device
    gn = torch.sqrt((g * g).sum() if sq_norm is None else sq_norm)
    g = torch.where(gn < f32(max_norm, dev), g, (g / gn) * f32(max_norm, dev))
    mu = f32(1.0 - b1, dev) * g + f32(b1, dev) * mu
    nu = f32(1.0 - b2, dev) * (g * g) + f32(b2, dev) * nu
    c1 = 1.0 - f32(b1, dev) ** t
    c2 = 1.0 - f32(b2, dev) ** t
    p = p + f32(-lr, dev) * ((mu / c1) / (torch.sqrt(nu / c2) + f32(eps, dev)))
    return p, mu, nu


class PPOAgent(Agent):
    name = "ppo-mlp"
    tp = None  # the tensor-parallel plan of a rank's copy (parallel/tp.py)

    def __init__(
        self,
        env,
        net: str = "mlp",
        lr: float = 3e-4,
        discount: float = 0.99,
        gae_lambda: float = 0.95,
        clipping: float = 0.2,
        entropy_bonus: float = 0.01,
        entropy_final: float | None = None,
        entropy_anneal_steps: int = 0,
        value_coef: float = 0.5,
        epochs: int = 4,
        n_minibatches: int = 4,
        max_grad_norm: float = 0.5,
        hidden: tuple = (128, 128),
    ):
        super().__init__(env)
        if net not in ("mlp", "table", "pallas", "cnn"):
            raise ValueError(f"unknown net {net!r}")
        if net == "table" and not isinstance(env, CompiledEnv):
            raise ValueError(f"{env.name}: net='table' needs a compiled env")
        self.net_kind = net
        self.hidden = tuple(hidden)
        self.name = f"ppo-{net}"
        self.discount = discount
        self.gae_lambda = gae_lambda
        self.clipping = clipping
        self.entropy_bonus = entropy_bonus
        self.entropy_final = entropy_bonus if entropy_final is None else entropy_final
        self.entropy_anneal_steps = entropy_anneal_steps
        self.value_coef = value_coef
        self.epochs = epochs
        self.n_minibatches = n_minibatches
        self.lr = lr
        self.max_grad_norm = max_grad_norm
        self.net = self._make_net(env)
        self.shapes = {k: tuple(v.shape) for k, v in self.net.named_parameters()}

    def _make_net(self, env):
        if self.net_kind == "table":
            obs = env.obs_table.reshape(env.obs_table.shape[0], -1)
            return TableActorCritic(obs, env.n_actions, self.hidden).to(env.device)
        if self.net_kind == "pallas":
            # Fused-kernel forward (ops/fused_mlp.py); fixed 128-wide layers.
            from ..ops.fused_mlp import PallasActorCriticMLP

            return PallasActorCriticMLP(obs_dim(env), env.n_actions)
        if self.net_kind == "cnn":
            return ActorCriticCNN(env.obs_shape, env.n_actions, hidden=self.hidden[0])
        return ActorCriticMLP(obs_dim(env), env.n_actions, self.hidden)

    @property
    def obs_flat(self) -> torch.Tensor:
        """The compiled env's observation table as ``[S, D]`` f32."""
        obs = self.env.obs_table
        return obs.reshape(obs.shape[0], -1)

    def init(self, device=None, seed: int = 0) -> PPOState:
        """flax-style initial params from a CPU generator seeded ``seed``."""
        dev = resolve_device(device)
        params = self.net.init_params(torch.Generator().manual_seed(seed), dev)
        zeros = torch.zeros_like(ravel(params))
        zero64 = torch.zeros((), dtype=torch.int64, device=dev)
        return PPOState(params=params, mu=zeros, nu=zeros.clone(), count=zero64,
                        step=zero64.clone())

    def policy_value(self, params: Params, env_states) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched ``(logits [N, A], value [N])`` from compact env states."""
        if self.net_kind == "table":
            return self.net.apply(params, env_states.idx)
        return self.net.apply(params, self.env.observe(env_states))

    def for_env(self, env) -> "PPOAgent":
        """Bound to another, shape-compatible env; the table net's fold is
        rebuilt from that env's observation table."""
        c = super().for_env(env)
        c.net = self._make_net(env)
        if self.tp is not None:
            c.net = self.tp.shard_net(c.net)
        return c

    def act(self, astate: PPOState, env_states) -> torch.Tensor:
        """Greedy actions; ties go to the lowest action."""
        logits, _ = self.policy_value(astate.params, env_states)
        return logits.argmax(-1).to(torch.int32)

    def act_idx(self, astate: PPOState, idx: torch.Tensor) -> torch.Tensor:
        return self.act(astate, TableState(idx=idx, t=torch.zeros_like(idx)))

    def sample_action(self, params: Params, env_states, generator=None, u=None):
        """``(action, log_prob, value)`` of the collect: the action drawn
        from the policy by the Gumbel-max trick on ``u`` ``[N, A]`` uniform
        (drawn from ``generator`` when not given). The reference draws
        ``jax.random.categorical``: the same distribution, not the same
        bits."""
        logits, value = self.policy_value(params, env_states)
        if u is None:
            u = torch.rand(logits.shape, generator=generator, device=logits.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
        action = (logits + gumbel).argmax(-1).to(torch.int32)
        logp = torch.log_softmax(logits, -1)
        return action, logp.gather(-1, action.long()[:, None]).squeeze(-1), value

    def act_explore(self, astate: PPOState, env_states, generator=None) -> torch.Tensor:
        """An action sampled from the policy (``sample_action``)."""
        with torch.no_grad():
            return self.sample_action(astate.params, env_states, generator)[0]

    def entropy_coef(self, step: torch.Tensor) -> torch.Tensor:
        """The linearly annealed entropy bonus in float32, as the reference
        computes it (constant when ``entropy_anneal_steps <= 0``)."""
        if self.entropy_anneal_steps <= 0:
            return f32(self.entropy_bonus, step.device)
        return linear_epsilon(step, self.entropy_bonus, self.entropy_final,
                              self.entropy_anneal_steps)

    def loss(self, params: Params, batch: Dict, entropy_coef=None) -> torch.Tensor:
        """Clipped surrogate + value + entropy over one flat minibatch.

        ``batch`` leaves: ``states`` (a ``TableState`` of ``[B]``),
        ``actions``, ``old_logp``, ``advantages``, ``returns``, all ``[B]``."""
        logits, value = self.policy_value(params, batch["states"])
        logp = torch.log_softmax(logits, -1)
        logp_a = logp.gather(-1, batch["actions"].long()[:, None]).squeeze(-1)
        ratio = torch.exp(logp_a - batch["old_logp"])
        adv = batch["advantages"]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1.0 - self.clipping, 1.0 + self.clipping) * adv,
        )
        policy_loss = -surr.mean()
        value_loss = 0.5 * torch.square(value - batch["returns"]).mean()
        entropy = -(torch.exp(logp) * logp).sum(-1).mean()
        coef = f32(self.entropy_bonus, value.device) if entropy_coef is None else entropy_coef
        return policy_loss + self.value_coef * value_loss - coef * entropy

    def update(self, flat: torch.Tensor, mu, nu, count: torch.Tensor, batch: Dict,
               entropy_coef=None, group=None):
        """One minibatch step on the flat params: autograd of ``loss``, then
        ``clip_adam`` with Adam step ``count + 1``. Under data parallelism
        (``group``) the gradient and the loss are averaged over the ranks in
        one all-reduce before the clip (the reference's ``pmean``); under
        tensor parallelism ``flat`` is this rank's shard and the clip takes
        the norm of the whole tree (``self.tp``). Returns ``(flat, mu, nu,
        loss)``."""
        leaf = flat.detach().requires_grad_(True)
        loss = self.loss(unravel(leaf, self.shapes), batch, entropy_coef)
        (g,) = torch.autograd.grad(loss, [leaf])
        if group is not None:
            g, loss = pmean_flat((g, loss.detach()), group)
        t = (count + 1).to(torch.float32)
        sq = None if self.tp is None else self.tp.sq_norm(g)
        flat, mu, nu = clip_adam(flat.detach(), mu, nu, g, t, self.lr, self.max_grad_norm,
                                 sq_norm=sq)
        return flat, mu, nu, loss.detach()


class PPOCNNAgent(PPOAgent):
    """``PPOAgent`` with the convolutional net (the ``ppo-cnn`` alias)."""

    def __init__(self, env, **kw):
        kw.setdefault("net", "cnn")
        super().__init__(env, **kw)
