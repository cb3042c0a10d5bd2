"""Tabular Q-learning over the array engine: act-explore → step → learn,
one step at a time.

Counterpart of ``safe_grid_agents_tpu/training/tabular.py::TabularQTrainer``
(the CLI's ``<env> tabular-q`` without ``--mxu``, on the uncompiled envs or,
with ``--compiled``, on a ``CompiledEnv``). Each step indexes the lanes'
states, takes the ε-greedy actions, steps the engine and learns
``TabularQAgent.learn``'s duplicate-averaged TD update with the successor
index taken from the PRE-reset successor (``pre_reset_env``): the reset
state of a lane that just finished is not where its transition went.

Each step draws ``rand_a`` and ``u`` (``TabularQAgent.draw_explore``), then
the env's draws, from the run's ``torch.Generator``; ``train_chunk`` also
takes them handed over (``explore``: two ``[T, N]`` tensors; ``env_draws``:
T per-step dicts of ``ArrayVecEnv.step``), so that a test can replay the
reference's draws.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..agents.tabular import TabularQAgent, TabularQState
from ..envs.array_vec import ArrayVecEnv, VecState
from .common import ChunkStats, eval_chunk, reward_source


class TabularQTrainer:
    def __init__(self, agent: TabularQAgent, vec: ArrayVecEnv, cheat: bool = False):
        self.agent = agent
        self.vec = vec
        self.cheat = cheat

    def init(self, generator=None, seed: int = 0) -> Tuple[TabularQState, VecState]:
        del seed
        return self.agent.init(self.vec.device), self.vec.reset(generator)

    def train_chunk(self, astate: TabularQState, vstate: VecState, generator, n_steps: int,
                    explore: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    env_draws: Optional[List[dict]] = None):
        agent, vec, env = self.agent, self.vec, self.vec.env
        stats = ChunkStats.zero(vec.device)
        for s in range(n_steps):
            if explore is None:
                rand_a, u = agent.draw_explore(vec.n_envs, generator, vec.device)
            else:
                rand_a, u = explore[0][s], explore[1][s]
            s_idx = env.state_index(vstate.env)
            actions = agent.act_explore_idx(astate, s_idx, rand_a, u)
            vstate, out = vec.step(vstate, actions,
                                   None if env_draws is None else env_draws[s], generator)
            astate = agent.learn(astate, s_idx, actions, reward_source(out, self.cheat),
                                 env.state_index(out["pre_reset_env"]), out["done"])
            stats = stats.accumulate(out)
        return astate, vstate, stats

    def eval_chunk(self, astate: TabularQState, vstate: VecState, n_steps: int,
                   min_episodes: int | None = None, generator=None):
        return eval_chunk(self.vec, lambda a, vs: self.agent.act(a, vs.env), astate, vstate,
                          n_steps, min_episodes=min_episodes, generator=generator)
