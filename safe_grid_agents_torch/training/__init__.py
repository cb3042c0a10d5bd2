"""Trainers and shared loop machinery (counterpart of
``safe_grid_agents_tpu/training``). The port has the fused tabular-Q and
fused DQN trainers, DQN's n-step window push, the fast-mode MXU PPO trainer,
the fused PPO trainer and their PPO-CRMDP counterparts; ``training/tabular.py``,
the MXU tabular scan (ROADMAP A.6), the ``VecEnv`` DQN trainer (A.9) and the
base PPO and CRMDP trainers (A.10) are queued."""
from __future__ import annotations

from .common import ChunkStats, eval_chunk, stats_to_host
from .dqn import push_traj_windows
from .dqn_fused import FusedDQNTrainer
from .ppo import compute_gae, whiten
from .ppo_fused import FusedCRMDPTrainer, FusedPPOTrainer
from .ppo_mxu import MXUCRMDPTrainer, MXUPPOTrainer
from .tabular_fused import FusedTabularQTrainer

__all__ = ["ChunkStats", "FusedCRMDPTrainer", "FusedDQNTrainer", "FusedPPOTrainer",
           "FusedTabularQTrainer", "MXUCRMDPTrainer", "MXUPPOTrainer", "compute_gae",
           "eval_chunk", "push_traj_windows", "stats_to_host", "whiten"]
