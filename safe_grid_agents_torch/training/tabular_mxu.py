"""Tabular Q-learning over the compiled engine, one step at a time.

Counterpart of ``safe_grid_agents_tpu/training/tabular_mxu.py::
MXUTabularQTrainer`` (the CLI's ``<env> tabular-q --compiled --mxu``
without ``--fused-kernel``). Its act and learn are index-native: the lanes
carry their state indices, the greedy action is the argmax of Q's rows, and
the successor index is the engine's pre-reset ``next_idx``.

The reference writes Q's row reads and the TD scatter as one-hot matmuls
for the MXU; on the card the TD update stays the agent's scatter
(``TabularQAgent.learn``, ``index_add_``), the same update up to the
association of the float sums, as the reference's docstring says. No
``[N, S]`` one-hot is built (sokoban2 has S = 175,616).

Each step draws ``rand_a`` and ``u``, then a stochastic env's mechanics
(``VecEnv.draw_mechanics``), from the run's ``torch.Generator``;
``train_chunk`` also takes the explore draws handed over as two ``[T, N]``
tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..agents.tabular import TabularQAgent, TabularQState
from ..envs.vec import VecEnv, VecState
from .common import ChunkStats, engine_step, eval_chunk, reward_source


class MXUTabularQTrainer:
    def __init__(self, agent: TabularQAgent, vec: VecEnv, cheat: bool = False):
        self.agent = agent
        self.vec = vec
        self.cheat = cheat

    def init(self, generator=None, seed: int = 0) -> Tuple[TabularQState, VecState]:
        del seed
        return self.agent.init(self.vec.device), self.vec.reset(generator)

    def train_chunk(self, astate: TabularQState, vstate: VecState, generator, n_steps: int,
                    explore: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        agent, vec = self.agent, self.vec
        stats = ChunkStats.zero(vec.device)
        for s in range(n_steps):
            if explore is None:
                rand_a, u = agent.draw_explore(vec.n_envs, generator, vec.device)
            else:
                rand_a, u = explore[0][s], explore[1][s]
            s_idx = vstate.idx
            actions = agent.act_explore_idx(astate, s_idx, rand_a, u)
            vstate, out = engine_step(vec, vstate, actions, generator)
            astate = agent.learn(astate, s_idx, actions, reward_source(out, self.cheat),
                                 out["next_idx"], out["done"])
            stats = stats.accumulate(out)
        return astate, vstate, stats

    def eval_chunk(self, astate: TabularQState, vstate: VecState, n_steps: int,
                   min_episodes: int | None = None, generator=None):
        return eval_chunk(self.vec, lambda a, vs: self.agent.act_idx(a, vs.idx), astate,
                          vstate, n_steps, min_episodes=min_episodes, generator=generator)
