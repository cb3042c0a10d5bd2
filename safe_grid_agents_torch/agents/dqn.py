"""Deep Q-learning agent, uniform or prioritized replay.

Counterpart of ``safe_grid_agents_tpu/agents/dqn.py::DQNAgent``: an MLP
over the observation (or, on a compiled env, the table-folded net),
ε-greedy with a linear anneal, a replay ring of compact records, a target
net hard-synced every ``sync_every`` updates, the Huber TD loss (δ = 1, as
``optax.huber_loss``) and Adam. n-step windows arrive pre-summed in the
records, so the bootstrap pays γⁿ; double-Q lets the online net pick the
bootstrap action (first max) and the target net value it.

The ring holds compiled-env records (``replay.Transition``, which the fused
trainer's kernels write and read) or, given the lanes' state record at
``init``, the array engine's transitions (``replay.Experience``), whose
observations are rendered at update time. ``update`` is one sampled step:
autograd of the TD loss, Adam (``ops/dqn_update_kernel.py::
adam_reference``, the arithmetic kernel B4 is held to) and the scheduled
target sync; B4's plain version runs the same step (``sgd_step``).

With ``prioritized=True`` the ring keeps priorities (``utils/replay.py``):
``push`` enters records at the largest priority, ``update`` samples in
proportion to pᵅ, weights each Huber loss by its importance weight
(``(w·losses).mean()``, β annealed from ``per_beta`` to 1 over the ε
horizon) and writes the batch's pre-update |δ| back as its priorities.

The learner state is plain tensors: parameter dicts for the online and
target nets, Adam's moments in the same layout and its step count. The step
and update counters are int64 (the JAX reference's are int32 and wrap past
2³¹; ROADMAP C).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..envs.compiled import CompiledEnv, TableState
from ..ops.dqn_update_kernel import UpdateHyper, adam_reference
from ..parallel.collectives import pmean_flat
from ..types import first_leaf
from ..utils import replay
from .base import Agent, epsilon_greedy, explore_draws, linear_epsilon, obs_dim
from .networks import QMLP, TableQNet

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class DQNState:
    params: Params
    target_params: Params
    mu: Params                  # Adam first moments (optax.adam's mu)
    nu: Params                  # Adam second moments (nu)
    count: torch.Tensor         # 0-d i64 — Adam steps taken
    buffer: replay.BufferState
    step: torch.Tensor          # 0-d i64 — env steps seen (drives the ε anneal)
    updates: torch.Tensor       # 0-d i64 — gradient updates (drives target sync)


def huber(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``optax.huber_loss`` with δ = 1, elementwise, in its arithmetic."""
    abs_err = (pred - target).abs()
    quadratic = abs_err.clamp(max=1.0)
    linear = abs_err - quadratic
    return 0.5 * quadratic * quadratic + linear


class DQNAgent(Agent):
    name = "deep-q"

    def __init__(
        self,
        env,
        lr: float = 1e-3,
        discount: float = 0.99,
        epsilon: float = 1.0,
        epsilon_final: float = 0.05,
        epsilon_anneal_steps: int = 300_000,
        batch_size: int = 256,
        replay_capacity: int = 100_000,
        sync_every: int = 200,
        hidden: tuple = (128, 128),
        table: bool = False,
        double_q: bool = False,
        prioritized: bool = False,
        per_alpha: float = 0.6,
        per_beta: float = 0.4,
        per_clip: float = 1.0,
        per_eps: float = 0.05,
        n_step: int = 1,
    ):
        super().__init__(env)
        if n_step < 1:
            raise ValueError(f"n_step must be >= 1, got {n_step}")
        if table and not isinstance(env, CompiledEnv):
            raise ValueError(f"{env.name}: table=True needs a compiled env")
        self.n_step = n_step
        self.double_q = double_q
        self.prioritized = prioritized
        self.per_alpha = per_alpha
        self.per_beta = per_beta
        self.per_clip = per_clip
        self.per_eps = per_eps
        self.discount = discount
        self.epsilon = epsilon
        self.epsilon_final = epsilon_final
        self.epsilon_anneal_steps = epsilon_anneal_steps
        self.batch_size = batch_size
        self.replay_capacity = replay_capacity
        self.sync_every = sync_every
        self.lr = lr
        self.hidden = tuple(hidden)
        self.table = table
        self.net = self._make_net(env)

    def _make_net(self, env):
        if self.table:
            obs = env.obs_table.reshape(env.obs_table.shape[0], -1)
            return TableQNet(obs, env.n_actions, self.hidden).to(env.device)
        return QMLP(obs_dim(env), env.n_actions, self.hidden)

    @property
    def obs_flat(self) -> torch.Tensor:
        """The compiled env's observation table as ``[S, D]`` f32."""
        obs = self.env.obs_table
        return obs.reshape(obs.shape[0], -1)

    def init(self, device=None, seed: int = 0, states=None) -> DQNState:
        """flax-style initial params from a CPU generator seeded ``seed``.
        The ring holds compiled-env records, or, given the lanes' env state
        record ``states``, array-engine transitions of its fields."""
        dev = resolve_device(device)
        params = self.net.init_params(torch.Generator().manual_seed(seed), dev)
        zero64 = torch.zeros((), dtype=torch.int64, device=dev)
        if states is None:
            buffer = replay.init(self.replay_capacity, dev, self.prioritized)
        else:
            n = first_leaf(states).shape[0]
            buffer = replay.init_like(self.replay_capacity, replay.Experience(
                state=states, action=torch.zeros(n, dtype=torch.int32, device=dev),
                reward=torch.zeros(n, dtype=torch.float32, device=dev), next_state=states,
                done=torch.zeros(n, dtype=torch.bool, device=dev)), self.prioritized)
        return DQNState(
            params=params,
            target_params={k: v.clone() for k, v in params.items()},
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            count=zero64.clone(),
            buffer=buffer,
            step=zero64.clone(),
            updates=zero64.clone(),
        )

    def current_epsilon(self, step: torch.Tensor) -> torch.Tensor:
        """Linear anneal in float32, as the reference computes it."""
        return linear_epsilon(step, self.epsilon, self.epsilon_final,
                              self.epsilon_anneal_steps)

    def current_beta(self, step: torch.Tensor) -> torch.Tensor:
        """PER's importance exponent, annealed from ``per_beta`` to 1 over
        the ε horizon (full correction by convergence, Schaul et al.)."""
        return linear_epsilon(step, self.per_beta, 1.0, self.epsilon_anneal_steps)

    def q_values(self, params: Params, env_states) -> torch.Tensor:
        if self.table:
            return self.net.apply(params, env_states.idx)
        return self.net.apply(params, self.env.observe(env_states))

    def act(self, astate: DQNState, env_states) -> torch.Tensor:
        """Greedy actions; ties go to the lowest action."""
        return self.q_values(astate.params, env_states).argmax(-1).to(torch.int32)

    def act_idx(self, astate: DQNState, idx: torch.Tensor) -> torch.Tensor:
        return self.act(astate, TableState(idx=idx, t=torch.zeros_like(idx)))

    def draw_explore(self, n: int, generator=None, device=None):
        """``(rand_a, u)`` of one ε-greedy step (``base.explore_draws``)."""
        return explore_draws(n, self.env.n_actions, generator, device)

    def act_explore(self, astate: DQNState, env_states, rand_a, u) -> torch.Tensor:
        """ε-greedy on the step's draws: ``rand_a`` where ``u < ε(step)``."""
        with torch.no_grad():
            greedy = self.act(astate, env_states)
        return epsilon_greedy(greedy, rand_a, u, self.current_epsilon(astate.step))

    def push(self, buffer: replay.BufferState, batch) -> replay.BufferState:
        """Append a batch of records to whichever ring this agent keeps."""
        if self.prioritized:
            return replay.push_batch_prioritized(buffer, batch, eps=self.per_eps,
                                                 clip=self.per_clip)
        return replay.push_batch(buffer, batch)

    def for_env(self, env) -> "DQNAgent":
        """Bound to another, shape-compatible env; the table net's
        fold is rebuilt from that env's observation table."""
        c = super().for_env(env)
        c.net = self._make_net(env)
        return c

    def td_components(self, params: Params, target_params: Params,
                      batch: replay.Transition) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-sample (Huber losses, TD errors) of a sampled batch of either
        record."""
        if isinstance(batch, replay.Experience):
            state, nxt = batch.state, batch.next_state
        else:
            state = TableState(idx=batch.s_idx, t=batch.s_t)
            nxt = TableState(idx=batch.n_idx, t=batch.n_t)
        q = self.q_values(params, state)
        q_next = self.q_values(target_params, nxt)
        q_sa = q.gather(-1, batch.action.long()[:, None]).squeeze(-1)
        if self.double_q:
            a_star = self.q_values(params, nxt).detach().argmax(-1)
            boot = q_next.gather(-1, a_star[:, None]).squeeze(-1)
        else:
            boot = q_next.amax(-1)
        gamma_n = float(np.float32(self.discount ** self.n_step))
        target = (batch.reward + gamma_n * torch.where(
            batch.done, torch.zeros_like(boot), boot)).detach()
        return huber(q_sa, target), q_sa - target

    def td_loss(self, params: Params, target_params: Params,
                batch: replay.Transition) -> torch.Tensor:
        losses, _ = self.td_components(params, target_params, batch)
        return losses.mean()

    def sgd_step(self, params: Params, target: Params, mu: Params, nu: Params,
                 count: torch.Tensor, updates: torch.Tensor, batch, weights=None,
                 group=None):
        """One update on ``batch``: autograd of the TD loss (each Huber loss
        weighted by ``weights`` when given, PER's importance weights), Adam
        step ``count + 1``, and the target synced where ``updates + 1`` is a
        multiple of ``sync_every``. Returns ``(params, target, mu, nu, loss,
        td)`` with the batch's pre-update TD errors ``td``. Under data
        parallelism (``group``) the gradients and the loss are averaged over
        the ranks, raveled into one all-reduce, before Adam (the
        reference's ``pmean``); ``td`` stays this rank's."""
        hyper = UpdateHyper.from_agent(self)
        names = list(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        losses, td = self.td_components(leaves, target, batch)
        loss = losses.mean() if weights is None else (weights * losses).mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        if group is not None:
            *grads, loss = pmean_flat(list(grads) + [loss.detach()], group)
        t = (count + 1).to(torch.float32)
        new_p, new_m, new_v = {}, {}, {}
        for k, g in zip(names, grads):
            new_p[k], new_m[k], new_v[k] = adam_reference(params[k].detach(), mu[k], nu[k],
                                                          g, t, hyper)
        sync = (updates + 1) % hyper.sync_every == 0
        target = {k: torch.where(sync, new_p[k], target[k]) for k in names}
        return new_p, target, new_m, new_v, loss.detach(), td.detach()

    def update(self, astate: DQNState, generator=None,
               slots: torch.Tensor | None = None, group=None):
        """One sampled update (``sgd_step``) on ``batch_size`` records drawn
        from the ring (uniformly, or by priority with the importance weights
        and the priority write-back), or on the ring's ``slots`` when given.
        Under data parallelism each rank samples its own ring and ``group``
        averages the gradients. Returns ``(astate, loss)``."""
        buf = astate.buffer
        weights = None
        if self.prioritized:
            slots, weights = replay.sample_prioritized(
                buf, generator, self.batch_size, self.per_alpha,
                self.current_beta(astate.step), slots=slots)
        elif slots is None:
            slots = replay.sample_slots(buf, generator, self.batch_size)
        params, target, mu, nu, loss, td = self.sgd_step(
            astate.params, astate.target_params, astate.mu, astate.nu, astate.count,
            astate.updates, replay.gather(buf, slots), weights, group)
        if self.prioritized:
            # The pre-update |δ| (clipped) becomes the sampled slots' priority.
            buf = replay.update_priorities(buf, slots, td, eps=self.per_eps,
                                           clip=self.per_clip)
        return dataclasses.replace(astate, params=params, target_params=target, mu=mu, nu=nu,
                                   count=astate.count + 1, updates=astate.updates + 1,
                                   buffer=buf), loss
