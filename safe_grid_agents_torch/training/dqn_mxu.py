"""DQN over the compiled engine: a step-by-step collect, then the autograd
update scan.

Counterpart of ``safe_grid_agents_tpu/training/dqn_mxu.py::MXUDQNTrainer``
(the CLI's ``<env> deep-q --compiled --mxu`` without ``--fused-kernel``).
The replay records are compact ``replay.Transition``s (a state index and
a step count each); observations render at update time through the
compiled env's observation table, so the agent (``DQNAgent``, MLP or
table-folded net, uniform or prioritized) is unchanged. A chunk:

1. ``_collect``: T steps of N lanes on the ``VecEnv``. Each step draws
   ``rand_a`` and ``u`` (or, in warmup, uniform actions) from the run's
   ``torch.Generator``, acts ε-greedily on the lanes' ``TableState``
   (``DQNAgent.act_explore``; the ε anneal's step counter advances every
   step), then, on a stochastic alias, draws ``VecEnv.draw_mechanics
   (generator, 1)`` for the step. The successor's step count is
   ``where(done, pre.t + 1, t)``: the terminal ``t + 1`` on a done step,
   not the reset lane's 0. The chunk's trajectory is pushed once, as
   n-step windows (``push_traj_windows``, through ``agent.push`` and so
   with PER's entry priorities);
2. ``_update_scan``: U × ``DQNAgent.update``, uniform or prioritized. Under
   PER each update samples after the previous one's priority write, so the
   scan is sequential. The reference ravels the parameters into one vector
   only to run fewer XLA kernels; Adam and the target sync are elementwise,
   so the per-parameter update here is the same arithmetic.

``FusedDQNTrainer`` (``training/dqn_fused.py``) is this trainer with its
collect in one kernel launch (B3, or B9 on a stochastic alias), and with
its update scan in one launch of B4 where B4 takes the net; elsewhere it
runs this scan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..agents.dqn import DQNAgent, DQNState
from ..envs.compiled import TableState
from ..envs.vec import VecEnv, VecState
from .common import ChunkStats, eval_chunk, reward_source
from .dqn import push_traj_windows


class MXUDQNTrainer:
    def __init__(self, agent: DQNAgent, vec: VecEnv, cheat: bool = False,
                 updates_per_chunk: int | None = None):
        self.agent = agent
        self.vec = vec
        self.cheat = cheat
        self.updates_per_chunk = updates_per_chunk
        self.device = vec.device

    def init(self, seed: int = 0, generator=None) -> Tuple[DQNState, VecState]:
        """Fresh params and a ring of compact records; fresh lanes (a coin
        reset draws from ``generator``)."""
        return self.agent.init(self.device, seed), self.vec.reset(generator)

    def _collect(self, astate: DQNState, vstate: VecState, generator, n_steps: int,
                 random_policy: bool, actions: Optional[torch.Tensor] = None,
                 env_draws: Optional[tuple] = None):
        """T steps, then one push of the chunk's windows. ``actions``
        ``[T, N]`` replaces the policy's actions and ``env_draws`` (``bits,
        stumble, rand_a``, each ``[T, N]``) a stochastic env's draws."""
        agent, vec = self.agent, self.vec
        n, dev = vec.n_envs, self.device
        stats = ChunkStats.zero(dev)
        recs = {k: [] for k in ("idx", "t", "action", "reward", "n_idx", "n_t", "done")}
        for s in range(n_steps):
            pre = TableState(idx=vstate.idx, t=vstate.t)
            if actions is not None:
                act = actions[s]
            elif random_policy:
                act = torch.randint(0, vec.A, (n,), dtype=torch.int32, generator=generator,
                                    device=dev)
            else:
                rand_a, u = agent.draw_explore(n, generator, dev)
                act = agent.act_explore(astate, pre, rand_a, u)
            draws = None
            if vec.stochastic:
                draws = (tuple(d[s] for d in env_draws) if env_draws is not None
                         else tuple(d[0] for d in vec.draw_mechanics(generator, 1)))
            vstate, out = vec.step(vstate, act, draws)
            astate = dataclasses.replace(astate, step=astate.step + n)
            stats = stats.accumulate(out)
            for k, x in (("idx", pre.idx), ("t", pre.t), ("action", act),
                         ("reward", reward_source(out, self.cheat)),
                         ("n_idx", out["next_idx"]),
                         ("n_t", torch.where(out["done"], pre.t + 1, vstate.t)),
                         ("done", out["done"])):
                recs[k].append(x)
        traj = {k: torch.stack(v) for k, v in recs.items()}
        buffer = push_traj_windows(agent, astate.buffer, (
            TableState(idx=traj["idx"], t=traj["t"]), traj["action"], traj["reward"],
            TableState(idx=traj["n_idx"], t=traj["n_t"]), traj["done"]))
        return dataclasses.replace(astate, buffer=buffer), vstate, stats

    def warmup_chunk(self, astate: DQNState, vstate, generator, n_steps: int):
        """Random-policy replay fill (the reference's dqn warmup)."""
        return self._collect(astate, vstate, generator, n_steps, random_policy=True)

    def _update_scan(self, astate: DQNState, generator, n_updates: int,
                     slots: Optional[torch.Tensor] = None,
                     group=None) -> Tuple[DQNState, torch.Tensor]:
        """``n_updates`` × ``DQNAgent.update`` (uniform or prioritized), each
        drawing its batch from ``generator`` or taking ``slots[u]`` (``[U,
        B]``); ``group`` averages each update's gradients over the ranks.
        Returns the state and the updates' mean loss."""
        losses = []
        for u in range(n_updates):
            astate, loss = self.agent.update(astate, generator,
                                             None if slots is None else slots[u], group)
            losses.append(loss)
        return astate, torch.stack(losses).mean()

    def train_chunk(self, astate: DQNState, vstate, generator, n_steps: int, group=None):
        """T env steps (collect), then U sampled updates; returns ``(astate,
        vstate, stats, loss)`` with the mean loss of the U updates. ``group``
        averages each update's gradients over the ranks."""
        astate, vstate, stats = self._collect(astate, vstate, generator, n_steps,
                                              random_policy=False)
        astate, loss = self._update_scan(astate, generator,
                                         self.updates_per_chunk or n_steps, group=group)
        return astate, vstate, stats, loss

    def eval_chunk(self, astate: DQNState, vstate: VecState, n_steps: int,
                   min_episodes: int | None = None, generator=None):
        """Greedy eval on the ``VecEnv`` from ``vstate`` (the CLI passes a
        fresh ``vec.reset(generator)``); a stochastic env draws from
        ``generator``."""
        with torch.no_grad():
            return eval_chunk(self.vec, lambda a, vs: self.agent.act_idx(a, vs.idx), astate,
                              vstate, n_steps, min_episodes=min_episodes,
                              generator=generator)
