"""Trainers and shared loop machinery (counterpart of
``safe_grid_agents_tpu/training``). This slice ports the fused tabular-Q
trainer; ``training/tabular.py`` and the MXU tabular scan are queued
(ROADMAP A.6)."""
from __future__ import annotations

from .common import ChunkStats, eval_chunk, stats_to_host
from .tabular_fused import FusedTabularQTrainer

__all__ = ["ChunkStats", "FusedTabularQTrainer", "eval_chunk", "stats_to_host"]
