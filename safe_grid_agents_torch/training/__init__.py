"""Trainers and shared loop machinery (counterpart of
``safe_grid_agents_tpu/training``).

* over the array engine (``envs/array_vec.py``): ``TabularQTrainer``,
  ``DQNTrainer``, ``PPOTrainer``, ``CRMDPTrainer`` and ``DummyTrainer``,
  registered by agent alias in ``TRAINER_REGISTRY`` (``make_trainer``);
* over the compiled engine (``envs/vec.py``): the MXU tabular scan
  ``MXUTabularQTrainer``, the MXU DQN trainer (``MXUDQNTrainer``: a
  step-by-step collect, then the autograd update scan, uniform or
  prioritized), the MXU PPO and PPO-CRMDP trainers (fast and parity
  modes), and the fused tabular-Q, DQN, PPO and PPO-CRMDP trainers (one
  kernel per phase; the fused DQN trainer falls back to ``MXUDQNTrainer``'s
  update scan where its update kernel does not take the net).
"""
from __future__ import annotations

from typing import Callable, Dict

from .common import ChunkStats, eval_chunk, stats_to_host
from .crmdp import CRMDPTrainer
from .dqn import DQNTrainer, push_traj_windows
from .dqn_fused import FusedDQNTrainer
from .dqn_mxu import MXUDQNTrainer
from .dummy import DummyTrainer
from .ppo import PPOTrainer, compute_gae, whiten
from .ppo_fused import FusedCRMDPTrainer, FusedPPOTrainer
from .ppo_mxu import MXUCRMDPTrainer, MXUPPOTrainer
from .tabular import TabularQTrainer
from .tabular_fused import FusedTabularQTrainer
from .tabular_mxu import MXUTabularQTrainer

TRAINER_REGISTRY: Dict[str, Callable] = {
    "random": DummyTrainer,
    "single": DummyTrainer,
    "tabular-q": TabularQTrainer,
    "deep-q": DQNTrainer,
    "ppo-mlp": PPOTrainer,
    "ppo-cnn": PPOTrainer,
    "ppo-crmdp": CRMDPTrainer,
}


def make_trainer(agent_alias: str, agent, vec, **kwargs):
    """The array-engine trainer of ``agent_alias`` over ``vec``."""
    if agent_alias not in TRAINER_REGISTRY:
        raise KeyError(f"no trainer for agent alias {agent_alias!r}")
    return TRAINER_REGISTRY[agent_alias](agent, vec, **kwargs)


__all__ = ["CRMDPTrainer", "ChunkStats", "DQNTrainer", "DummyTrainer", "FusedCRMDPTrainer",
           "FusedDQNTrainer", "FusedPPOTrainer", "FusedTabularQTrainer", "MXUCRMDPTrainer",
           "MXUDQNTrainer", "MXUPPOTrainer", "MXUTabularQTrainer", "PPOTrainer", "TRAINER_REGISTRY",
           "TabularQTrainer", "compute_gae", "eval_chunk", "make_trainer",
           "push_traj_windows", "stats_to_host", "whiten"]
