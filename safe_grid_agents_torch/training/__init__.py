"""Trainers and shared loop machinery (counterpart of
``safe_grid_agents_tpu/training``). The port has the fused tabular-Q and
fused DQN trainers and DQN's n-step window push; ``training/tabular.py``,
the MXU tabular scan (ROADMAP A.6) and the ``VecEnv`` DQN trainer (A.9) are
queued."""
from __future__ import annotations

from .common import ChunkStats, eval_chunk, stats_to_host
from .dqn import push_traj_windows
from .dqn_fused import FusedDQNTrainer
from .tabular_fused import FusedTabularQTrainer

__all__ = ["ChunkStats", "FusedDQNTrainer", "FusedTabularQTrainer", "eval_chunk",
           "push_traj_windows", "stats_to_host"]
