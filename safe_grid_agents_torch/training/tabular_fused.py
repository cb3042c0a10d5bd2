"""Tabular Q-learning with the whole act → step → learn loop in one kernel.

Counterpart of the deterministic branch of
``safe_grid_agents_tpu/training/tabular_pallas.py``: each chunk draws its
random actions and exploration uniforms in bulk (``[T, N]`` each, from the
run's ``torch.Generator``) and hands them to ``ops/tabular_kernel.py::tabq``,
which keeps Q resident for the chunk's T steps. Greedy eval steps the
``VecEnv`` with the argmax of Q's rows (as ``tabular_mxu.py``'s eval does).

Scope: deterministic-reset compiled envs with N ≤ 4096 lanes (one thread
block spans the whole TD batch, so every step's update covers all N lanes
exactly like the unfused trainers). The stochastic branch of the reference
(kernel B8) is not ported yet; single device; trains on the observed reward.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..agents.tabular import TabularQAgent, TabularQState
from ..envs.vec import VecEnv, VecState
from ..ops.rollout_kernel import Tables, reset_state
from ..ops.tabular_kernel import MAX_LANES, TabQHyper, tabq
from .common import ChunkStats, eval_chunk


class FusedTabularQTrainer:
    def __init__(self, agent: TabularQAgent, vec: VecEnv):
        if vec.n_envs > MAX_LANES:
            # The TD update is duplicate-averaged over the WHOLE N-lane batch
            # each step; splitting lanes over blocks would apply one block's
            # TD before another acts — a different algorithm.
            raise ValueError(f"the fused trainer takes --n-envs <= {MAX_LANES}")
        base = vec.cenv.base
        if hasattr(base, "noisy_action") or hasattr(base, "stochastic_index"):
            raise NotImplementedError(
                f"{vec.cenv.name}: the stochastic fused tabular kernel is not "
                "ported yet (ROADMAP B8)"
            )
        self.agent = agent
        self.vec = vec
        self.S, self.A = vec.S, vec.A
        self.device = vec.device
        self.tables = Tables.from_env(vec.cenv, vec.reset_idx)
        self.hyper = TabQHyper(
            float(agent.lr), float(agent.discount),
            float(agent.epsilon), float(agent.epsilon_final),
            float(max(agent.epsilon_anneal_steps, 1)),
        )

    def init(self) -> Tuple[TabularQState, tuple]:
        return (self.agent.init(self.device),
                reset_state(self.vec.n_envs, self.vec.reset_idx, self.device))

    def train_chunk(self, astate: TabularQState, vstate, generator: torch.Generator,
                    n_steps: int):
        n, dev = self.vec.n_envs, self.device
        rand_a = torch.randint(0, self.A, (n_steps, n), dtype=torch.int32,
                               generator=generator, device=dev)
        u = torch.rand((n_steps, n), dtype=torch.float32, generator=generator, device=dev)
        (q, idx, t, epr, eph, epl, step,
         eacc, racc, hacc, lacc) = tabq(
            self.tables, self.hyper, astate.q, vstate,
            astate.step.reshape(1), rand_a, u,
        )
        stats = ChunkStats(
            episodes=eacc.sum(),
            return_sum=racc.sum(),
            hidden_sum=hacc.sum(),
            length_sum=lacc.sum(),
            env_steps=torch.tensor(float(n_steps * n), device=dev),
        )
        return TabularQState(q=q, step=step.reshape(())), (idx, t, epr, eph, epl), stats

    def eval_chunk(self, astate: TabularQState, vstate: VecState, n_steps: int,
                   min_episodes: int | None = None):
        """Greedy eval on the ``VecEnv`` from ``vstate`` (the CLI passes a
        fresh ``vec.reset()``)."""
        return eval_chunk(
            self.vec, lambda a, vs: self.agent.act_idx(a, vs.idx), astate, vstate,
            n_steps, min_episodes=min_episodes,
        )
