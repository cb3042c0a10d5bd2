"""Data-parallel trainer wrapper over a ``DataGroup``.

Counterpart of ``safe_grid_agents_tpu/parallel/dp.py``. Each rank is one
process with one device. ``DPTrainer(trainer, group)`` wraps a trainer
built for the GLOBAL lane count N and runs, on each rank, a copy of it over
N/W lanes of its own (the reference's ``shard_map`` over ``data``): no
traffic while the lanes step; the learner state is replicated, and the
only communication is the all-reduces the family trainers make where they
are given ``group=`` (the reference's ``axis_name``): tabular TD sums and
counts, DQN and PPO gradients and losses, PPO whitening moments, CRMDP's
attribution step. Each chunk's statistics are summed over the ranks.

* Learner state: identical on every rank from ``init`` on, because the
  parameters come from the rank-independent ``seed`` (the agents' CPU
  generator); nothing is broadcast. Each rank's lanes reset from its own
  generator.
* Generators: each rank draws from its own ``torch.Generator``, seeded
  ``rank_seed(seed, rank)`` by the caller (the reference's
  ``jax.random.split(key, n_dev)``); ``DPTrainer`` takes it per call, as
  the trainers do, so at W = 1 a chunk is bitwise the unwrapped trainer's
  on the same generator.
* Replay: each rank keeps a ring of capacity ``replay_capacity / W``, fed
  by its own lanes and sampled by itself, priorities included: a global
  priorities array against local storage would scatter out of bounds and
  silently drop transitions (the reference's ``_astate_specs``).
* Eval: each rank runs to its local share ``ceil(min_episodes / W)`` with a
  rank-local loop condition and no collective inside the loop (ranks finish
  at different times; a collective there would deadlock them), then the
  statistics are summed.

The fused trainers are single-device (``ValueError``), as the reference's
CLI refuses them with ``--n-devices``.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..envs.vec import VecEnv
from ..envs.array_vec import ArrayVecEnv
from ..training import (
    ChunkStats, FusedDQNTrainer, FusedPPOTrainer, FusedTabularQTrainer,
)
from .collectives import psum
from .mesh import DataGroup

FUSED = (FusedTabularQTrainer, FusedDQNTrainer, FusedPPOTrainer)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator in a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def psum_stats(stats: ChunkStats, group: DataGroup) -> ChunkStats:
    """Each field of ``stats`` summed over the ranks (one all-reduce of the
    five float32 sums; episode counts and lengths are integers, exact in
    float32 below 2²⁴, and gridworld rewards are multiples of 0.5)."""
    fields = (stats.episodes, stats.return_sum, stats.hidden_sum, stats.length_sum,
              stats.env_steps)
    return ChunkStats(*psum(torch.stack(fields), group).unbind(0))


def local_target(min_episodes: Optional[int], world: int) -> Optional[int]:
    """A rank's share of an eval's episode target: ``ceil(E / W)``, so that
    W ranks cover the global target (floor could stop short of it)."""
    return None if min_episodes is None else max(1, -(-min_episodes // world))


def _local_trainer(trainer, n_local: int, world: int):
    """A copy of ``trainer`` over ``n_local`` lanes of its engine, with a
    replay ring of ``1/world`` of the capacity."""
    local = copy.copy(trainer)
    vec = trainer.vec
    local.vec = (VecEnv(vec.cenv, n_local) if isinstance(vec, VecEnv)
                 else ArrayVecEnv(vec.env, n_local, vec.device))
    capacity = getattr(trainer.agent, "replay_capacity", None)
    if capacity is not None:
        if capacity % world:
            raise ValueError(f"replay capacity {capacity} does not split over {world} ranks")
        local.agent = copy.copy(trainer.agent)
        local.agent.replay_capacity = capacity // world
    return local


class DPTrainer:
    """Wraps a base or MXU family trainer (tabular, DQN, PPO, CRMDP, dummy)
    for data parallelism over ``group``; its methods mirror the trainer's."""

    def __init__(self, trainer, group: DataGroup):
        if isinstance(trainer, FUSED):
            raise ValueError(f"{type(trainer).__name__} is single-device; the fused kernels "
                             "run one card (drop --n-devices)")
        n = trainer.vec.n_envs
        if n % group.world_size:
            raise ValueError(f"{n} envs not divisible by {group.world_size} ranks")
        self.group = group
        self.n_dev = group.world_size
        self.trainer = _local_trainer(trainer, n // self.n_dev, self.n_dev)

    @property
    def vec(self):
        """This rank's engine (N/W lanes)."""
        return self.trainer.vec

    def init(self, seed: int = 0, generator=None):
        """Replicated learner state (from ``seed``), this rank's lanes
        (from ``generator``)."""
        return self.trainer.init(seed=seed, generator=generator)

    def reset_envs(self, generator=None):
        """Fresh lanes of this rank."""
        return self.trainer.vec.reset(generator)

    @property
    def has_warmup(self) -> bool:
        return hasattr(self.trainer, "warmup_chunk")

    def train_chunk(self, astate, vstate, generator, n_steps: int):
        out = self.trainer.train_chunk(astate, vstate, generator, n_steps, group=self.group)
        return (out[0], out[1], psum_stats(out[2], self.group)) + tuple(out[3:])

    def warmup_chunk(self, astate, vstate, generator, n_steps: int):
        if not self.has_warmup:
            raise AttributeError(f"{type(self.trainer).__name__} has no warmup phase")
        astate, vstate, stats = self.trainer.warmup_chunk(astate, vstate, generator, n_steps)
        return astate, vstate, psum_stats(stats, self.group)

    def eval_chunk(self, astate, vstate, n_steps: int, min_episodes: Optional[int] = None,
                   generator=None):
        vstate, stats = self.trainer.eval_chunk(
            astate, vstate, n_steps, min_episodes=local_target(min_episodes, self.n_dev),
            generator=generator)
        return vstate, psum_stats(stats, self.group)
