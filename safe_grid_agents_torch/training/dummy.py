"""Trainer of the baseline agents (random, single-action): a rollout over
the array engine with episode accounting and nothing to learn.

Counterpart of ``safe_grid_agents_tpu/training/dummy.py``. Each step draws
the agent's actions, then the env's draws, from the run's
``torch.Generator``.
"""
from __future__ import annotations

from ..envs.array_vec import ArrayVecEnv
from .common import ChunkStats, eval_chunk


class DummyTrainer:
    def __init__(self, agent, vec: ArrayVecEnv, cheat: bool = False):
        del cheat  # nothing is trained
        self.agent = agent
        self.vec = vec

    def init(self, generator=None, seed: int = 0):
        del seed
        return self.agent.init(self.vec.device), self.vec.reset(generator)

    def train_chunk(self, astate, vstate, generator, n_steps: int, group=None):
        del group  # nothing is learned, so nothing is reduced
        stats = ChunkStats.zero(self.vec.device)
        for _ in range(n_steps):
            actions = self.agent.act_explore(astate, vstate.env, generator)
            vstate, out = self.vec.step(vstate, actions, generator=generator)
            stats = stats.accumulate(out)
        return astate, vstate, stats

    def eval_chunk(self, astate, vstate, n_steps: int, min_episodes: int | None = None,
                   generator=None):
        return eval_chunk(
            self.vec, lambda a, vs: self.agent.act(a, vs.env, generator), astate, vstate,
            n_steps, min_episodes=min_episodes, generator=generator)
