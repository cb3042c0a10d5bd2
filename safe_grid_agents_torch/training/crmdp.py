"""PPO-CRMDP over the array engine.

Counterpart of ``safe_grid_agents_tpu/training/crmdp.py::CRMDPTrainer`` (the
CLI's ``<env> ppo-crmdp`` without ``--mxu``): ``PPOTrainer``'s chunk with
the corruption attribution and the reward relabel (``PPOCRMDPAgent.
attribute``) between collect and GAE. The collect records each step's
arrival index from the PRE-reset successor: shifting the stored pre-step
states by one step would attribute a finished episode's last reward to the
next episode's start. CRMDP trains on the observed rewards, relabeled, so
``cheat`` is refused.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..agents.crmdp import CRMDPState, PPOCRMDPAgent
from ..envs.array_vec import VecState
from .ppo import PPOTrainer


class Attribution:
    """The CRMDP step of every PPO-CRMDP trainer: refuse ``cheat``, and run
    the attribution and the relabel before the PPO trainer's ``_learn``
    (mixed in ahead of a PPO trainer class)."""

    def __init__(self, agent: PPOCRMDPAgent, vec, cheat: bool = False, **kwargs):
        if cheat:
            raise ValueError("CRMDP trains on the observed (relabeled) rewards; drop --cheat")
        super().__init__(agent, vec, cheat=False, **kwargs)

    def _learn(self, astate: CRMDPState, vstate, traj: Dict, generator,
               perms: Optional[torch.Tensor], group=None):
        """The attribution and relabel on the chunk's arrivals, then the PPO
        trainer's ``_learn`` on the relabeled rewards; ``group`` averages the
        attribution step over the ranks too. Returns ``(CRMDPState, loss)``."""
        corruption, relabeled = self.agent.attribute(astate.corruption, traj, group)
        new, loss = super()._learn(astate, vstate, dict(traj, rewards=relabeled), generator,
                                   perms, group)
        return CRMDPState(params=new.params, mu=new.mu, nu=new.nu, count=new.count,
                          step=new.step, corruption=corruption), loss


class CRMDPTrainer(Attribution, PPOTrainer):
    def collect(self, astate, vstate: VecState, generator, n_steps: int,
                arrivals: bool = True, policy_draws: Optional[torch.Tensor] = None):
        return super().collect(astate, vstate, generator, n_steps, arrivals=True,
                               policy_draws=policy_draws)
