"""Tabular Q-learning agent.

Counterpart of ``safe_grid_agents_tpu/agents/tabular.py``: a dense
``[num_states, n_actions]`` Q table indexed by the env's perfect hash,
ε-greedy with a linear anneal, and a batched TD update in which duplicate
(s, a) pairs of one batch are averaged, each against the pre-update Q
(N = 1 recovers sequential Q-learning).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .base import Agent, epsilon_greedy, explore_draws, f32, linear_epsilon


@dataclasses.dataclass
class TabularQState:
    q: torch.Tensor     # [S, A] f32
    step: torch.Tensor  # 0-d i64 — global env steps seen (drives the ε anneal)


class TabularQAgent(Agent):
    name = "tabular-q"

    def __init__(
        self,
        env,
        lr: float = 0.1,
        discount: float = 0.99,
        epsilon: float = 1.0,
        epsilon_final: float = 0.01,
        epsilon_anneal_steps: int = 200_000,
    ):
        super().__init__(env)
        if env.num_states is None:
            raise ValueError(f"{env.name}: no tabular state index")
        self.lr = lr
        self.discount = discount
        self.epsilon = epsilon
        self.epsilon_final = epsilon_final
        self.epsilon_anneal_steps = epsilon_anneal_steps

    def init(self, device=None) -> TabularQState:
        dev = resolve_device(device)
        return TabularQState(
            q=torch.zeros((self.env.num_states, self.env.n_actions),
                          dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def current_epsilon(self, step: torch.Tensor) -> torch.Tensor:
        """Linear anneal in float32, as the reference computes it."""
        return linear_epsilon(step, self.epsilon, self.epsilon_final,
                              self.epsilon_anneal_steps)

    def act_idx(self, astate: TabularQState, idx: torch.Tensor) -> torch.Tensor:
        """Greedy actions from state indices; ties go to the lowest action."""
        return astate.q[idx.long()].argmax(-1).to(torch.int32)

    def act(self, astate: TabularQState, env_states) -> torch.Tensor:
        return self.act_idx(astate, self.env.state_index(env_states))

    def draw_explore(self, n: int, generator=None, device=None):
        """``(rand_a, u)`` of one ε-greedy step (``base.explore_draws``)."""
        return explore_draws(n, self.env.n_actions, generator, device)

    def act_explore_idx(self, astate: TabularQState, idx: torch.Tensor,
                        rand_a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """ε-greedy from state indices on the step's draws: ``rand_a`` where
        ``u < ε(step)``, else the greedy action."""
        return epsilon_greedy(self.act_idx(astate, idx), rand_a, u,
                              self.current_epsilon(astate.step))

    def act_explore(self, astate: TabularQState, env_states, rand_a, u) -> torch.Tensor:
        return self.act_explore_idx(astate, self.env.state_index(env_states), rand_a, u)

    def learn(
        self,
        astate: TabularQState,
        s_idx: torch.Tensor,     # [N] — pre-step state indices
        actions: torch.Tensor,   # [N]
        rewards: torch.Tensor,   # [N] f32
        next_idx: torch.Tensor,  # [N] — post-step (pre-reset) indices
        dones: torch.Tensor,     # [N] bool
    ) -> TabularQState:
        """Batched TD update with duplicate averaging:
        ``Q[s,a] += (lr · Σ td) / max(count, 1)`` per (s, a)."""
        q = astate.q
        dev = q.device
        S, A = q.shape
        boot = q[next_idx.long()].amax(-1)
        target = rewards + f32(self.discount, dev) * torch.where(
            dones, torch.zeros_like(boot), boot
        )
        k = s_idx.long() * A + actions.long()
        td = target - q.view(-1)[k]
        td_sum = torch.zeros(S * A, dtype=torch.float32, device=dev).index_add_(0, k, td)
        cnt = torch.zeros(S * A, dtype=torch.float32, device=dev).index_add_(
            0, k, torch.ones_like(td)
        )
        delta = f32(self.lr, dev) * td_sum / cnt.clamp_min(1.0)
        return TabularQState(q=q + delta.view(S, A), step=astate.step + s_idx.shape[0])
