"""DQN over the array engine, and the n-step replay windows every DQN
trainer pushes.

Counterpart of ``safe_grid_agents_tpu/training/dqn.py``.

``push_traj_windows``: a ``[T, N]`` chunk trajectory is post-processed into
window sums Rₜ⁽ⁿ⁾ = Σⱼ γʲ rₜ₊ⱼ, truncated at the first done (auto-reset means
rewards past a done belong to the next episode), bootstrapping from sₜ₊ₙ
with γⁿ; the windows are pushed time-major. The last n − 1 steps of each
chunk have no full window and are dropped. With n = 1 the pushed stream is
bitwise the per-step push. The states are compiled-env ``TableState``s for
the fused trainer's compact ring, or env state records for the array
engine's (``replay.Experience``).

``DQNTrainer`` (the CLI's ``<env> deep-q`` without ``--mxu``): each chunk
collects T steps — ε-greedy actions (``DQNAgent.act_explore``) on draws
from the run's ``torch.Generator``, then the engine's step; each transition
bootstraps from the PRE-reset successor — pushing every step's N
transitions as they come for ``n_step == 1`` and the chunk's windows once
for ``n_step > 1``; then ``updates_per_chunk`` (default T) sampled updates
(``DQNAgent.update``). ``warmup_chunk`` is the collect with uniform random
actions.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..agents.dqn import DQNAgent, DQNState
from ..envs.array_vec import ArrayVecEnv, VecState, stack_outs
from ..types import map_leaves
from ..utils import replay
from .common import ChunkStats, eval_chunk, reward_source


def _flat(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """[T, N, ...] → [t_out·N, ...], the first t_out steps, time-major."""
    x = x[:t_out]
    return x.reshape((-1,) + tuple(x.shape[2:]))


def push_traj_windows(agent, buffer: replay.BufferState, traj) -> replay.BufferState:
    """Push ``traj`` = (states, actions, rewards, next_states, dones) as
    n-step windows into ``buffer``'s kind of record through ``agent.push``
    (uniform, or prioritized with PER's entry priorities); states are
    ``TableState``s or env state records, every leaf ``[T, N, ...]``."""
    states, actions, rewards, next_states, dones = traj
    n = agent.n_step
    t_total = actions.shape[0]
    if n > t_total:
        raise ValueError(f"n_step={n} exceeds chunk length {t_total}")
    t_out = t_total - n + 1
    ret = torch.zeros_like(rewards[:t_out])
    alive = torch.ones_like(rewards[:t_out])
    for j in range(n):
        ret = ret + (float(np.float32(agent.discount ** j)) * alive) * rewards[j:j + t_out]
        alive = alive * (1.0 - dones[j:j + t_out].to(ret.dtype))
    if isinstance(buffer.storage, replay.Experience):
        return agent.push(buffer, replay.Experience(
            state=map_leaves(lambda x: _flat(x, t_out), states),
            action=_flat(actions, t_out),
            reward=_flat(ret, t_out),
            next_state=map_leaves(lambda x: _flat(x[n - 1:], t_out), next_states),
            done=_flat(alive == 0.0, t_out),
        ))
    batch = replay.Transition(
        s_idx=_flat(states.idx, t_out),
        s_t=_flat(states.t, t_out),
        action=_flat(actions, t_out),
        reward=_flat(ret, t_out),
        # sₜ₊ₙ is the (n−1)th step's successor; where a done cut the window
        # the bootstrap is masked by done anyway.
        n_idx=_flat(next_states.idx[n - 1:], t_out),
        n_t=_flat(next_states.t[n - 1:], t_out),
        done=_flat(alive == 0.0, t_out),
    )
    return agent.push(buffer, batch)


class DQNTrainer:
    def __init__(self, agent: DQNAgent, vec: ArrayVecEnv, cheat: bool = False,
                 updates_per_chunk: int | None = None):
        self.agent = agent
        self.vec = vec
        self.cheat = cheat
        self.updates_per_chunk = updates_per_chunk
        self.device = vec.device

    def init(self, seed: int = 0, generator=None) -> Tuple[DQNState, VecState]:
        """Fresh params, a ring of the env's transitions, fresh lanes."""
        vstate = self.vec.reset(generator)
        return self.agent.init(self.device, seed, states=vstate.env), vstate

    def _collect(self, astate: DQNState, vstate: VecState, generator, n_steps: int,
                 random_policy: bool):
        agent, vec = self.agent, self.vec
        n = vec.n_envs
        streaming = agent.n_step == 1
        stats = ChunkStats.zero(self.device)
        steps = []
        for _ in range(n_steps):
            if random_policy:
                actions = torch.randint(0, vec.env.n_actions, (n,), dtype=torch.int32,
                                        generator=generator, device=self.device)
            else:
                rand_a, u = agent.draw_explore(n, generator, self.device)
                actions = agent.act_explore(astate, vstate.env, rand_a, u)
            pre = vstate.env
            vstate, out = vec.step(vstate, actions, generator=generator)
            rec = replay.Experience(state=pre, action=actions,
                                    reward=reward_source(out, self.cheat),
                                    next_state=out["pre_reset_env"], done=out["done"])
            buffer = agent.push(astate.buffer, rec) if streaming else astate.buffer
            if not streaming:
                steps.append(rec)
            astate = dataclasses.replace(astate, buffer=buffer, step=astate.step + n)
            stats = stats.accumulate(out)
        if not streaming:
            traj = stack_outs(steps)
            astate = dataclasses.replace(astate, buffer=push_traj_windows(
                agent, astate.buffer, (traj.state, traj.action, traj.reward, traj.next_state,
                                       traj.done)))
        return astate, vstate, stats

    def warmup_chunk(self, astate: DQNState, vstate: VecState, generator, n_steps: int):
        """Random-policy replay fill (the reference's dqn warmup)."""
        return self._collect(astate, vstate, generator, n_steps, random_policy=True)

    def train_chunk(self, astate: DQNState, vstate: VecState, generator, n_steps: int,
                    group=None):
        """T env steps (collect), then U sampled updates; returns ``(astate,
        vstate, stats, loss)`` with the mean loss of the U updates. ``group``
        averages each update's gradients over the ranks."""
        astate, vstate, stats = self._collect(astate, vstate, generator, n_steps,
                                              random_policy=False)
        losses = []
        for _ in range(self.updates_per_chunk or n_steps):
            astate, loss = self.agent.update(astate, generator, group=group)
            losses.append(loss)
        return astate, vstate, stats, torch.stack(losses).mean()

    def eval_chunk(self, astate: DQNState, vstate: VecState, n_steps: int,
                   min_episodes: int | None = None, generator=None):
        with torch.no_grad():
            return eval_chunk(self.vec, lambda a, vs: self.agent.act(a, vs.env), astate,
                              vstate, n_steps, min_episodes=min_episodes,
                              generator=generator)
