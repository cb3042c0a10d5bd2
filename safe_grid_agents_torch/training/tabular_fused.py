"""Tabular Q-learning with the whole act → step → learn loop in one kernel.

Counterpart of ``safe_grid_agents_tpu/training/tabular_pallas.py``. Each
chunk draws its streams in bulk from the run's ``torch.Generator`` and
hands them to one kernel launch, which keeps Q resident for the chunk's T
steps:

* deterministic envs: ``rand_a`` then ``u`` (``[T, N]`` each) into
  ``ops/tabular_kernel.py::tabq`` (B2);
* stochastic envs (coin and carried resets, whisky's noise, tomato's
  drying): the five streams ``rand_a``, ``u``, then ``VecEnv.
  draw_mechanics``'s ``bits, stumble, rand2``, into
  ``ops/tabular_stoch_kernel.py::tabq_stoch`` (B8); chunk lengths are
  multiples of 32 there.

Greedy eval steps the ``VecEnv`` with the argmax of Q's rows (as
``tabular_mxu.py``'s eval does), drawing a stochastic env's per-step draws
from the generator it is given.

Scope: N ≤ 4096 lanes (one thread block spans the whole TD batch, so every
step's update covers all N lanes exactly like the unfused trainers); single
device; trains on the observed reward.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..agents.tabular import TabularQAgent, TabularQState
from ..envs.vec import VecEnv, VecState
from ..ops.rollout_kernel import Tables
from ..ops.tabular_kernel import MAX_LANES, TabQHyper, tabq
from ..ops.tabular_stoch_kernel import TB_TS, tabq_stoch
from .common import ChunkStats, eval_chunk


class FusedTabularQTrainer:
    def __init__(self, agent: TabularQAgent, vec: VecEnv):
        if vec.n_envs > MAX_LANES:
            # The TD update is duplicate-averaged over the WHOLE N-lane batch
            # each step; splitting lanes over blocks would apply one block's
            # TD before another acts — a different algorithm.
            raise ValueError(f"the fused trainer takes --n-envs <= {MAX_LANES}")
        self.agent = agent
        self.vec = vec
        self.S, self.A = vec.S, vec.A
        self.device = vec.device
        self.stochastic = vec.stochastic
        if self.stochastic:
            self.tables = vec.tables
        else:
            self.tables = Tables.from_env(vec.cenv, vec.reset_idx)
        self.hyper = TabQHyper(
            float(agent.lr), float(agent.discount),
            float(agent.epsilon), float(agent.epsilon_final),
            float(max(agent.epsilon_anneal_steps, 1)),
        )

    def init(self, generator=None) -> Tuple[TabularQState, tuple]:
        """Zero Q and fresh lanes as ``(1, N)`` tensors; a coin reset draws
        from ``generator``."""
        vs = self.vec.reset(generator)
        return self.agent.init(self.device), tuple(
            x[None] for x in (vs.idx, vs.t, vs.ep_return, vs.ep_hidden, vs.ep_len))

    def train_chunk(self, astate: TabularQState, vstate, generator: torch.Generator,
                    n_steps: int):
        n, dev = self.vec.n_envs, self.device
        if self.stochastic and n_steps % TB_TS:
            raise ValueError(f"chunk steps {n_steps} must be a multiple of {TB_TS}")
        rand_a = torch.randint(0, self.A, (n_steps, n), dtype=torch.int32,
                               generator=generator, device=dev)
        u = torch.rand((n_steps, n), dtype=torch.float32, generator=generator, device=dev)
        step0 = astate.step.reshape(1)
        if self.stochastic:
            outs = tabq_stoch(self.tables, self.hyper, astate.q, vstate, step0, rand_a, u,
                              *self.vec.draw_mechanics(generator, n_steps))
        else:
            outs = tabq(self.tables, self.hyper, astate.q, vstate, step0, rand_a, u)
        (q, idx, t, epr, eph, epl, step, eacc, racc, hacc, lacc) = outs
        stats = ChunkStats(
            episodes=eacc.sum(),
            return_sum=racc.sum(),
            hidden_sum=hacc.sum(),
            length_sum=lacc.sum(),
            env_steps=torch.tensor(float(n_steps * n), device=dev),
        )
        return TabularQState(q=q, step=step.reshape(())), (idx, t, epr, eph, epl), stats

    def eval_chunk(self, astate: TabularQState, vstate: VecState, n_steps: int,
                   min_episodes: int | None = None, generator=None):
        """Greedy eval on the ``VecEnv`` from ``vstate`` (the CLI passes a
        fresh ``vec.reset(generator)``); a stochastic env draws from
        ``generator``."""
        return eval_chunk(
            self.vec, lambda a, vs: self.agent.act_idx(a, vs.idx), astate, vstate,
            n_steps, min_episodes=min_episodes, generator=generator,
        )
