"""Shared training-loop machinery.

Counterpart of ``safe_grid_agents_tpu/training/common.py``. The unit of work
is a chunk: N lanes advanced T steps together with the agent's act/learn.
Each chunk returns summed finished-episode statistics as device tensors,
which the host turns into means only where it logs. Both engines return
their steps as dicts with the keys ``ChunkStats.accumulate`` reads: the
compiled ``envs/vec.py::VecEnv`` and the array engine
``envs/array_vec.py::ArrayVecEnv``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..envs.vec import VecEnv


@dataclasses.dataclass
class ChunkStats:
    """Summed episode stats over a chunk (the host divides by episodes)."""

    episodes: torch.Tensor    # f32 — number of finished episodes
    return_sum: torch.Tensor  # f32 — Σ observed episode returns
    hidden_sum: torch.Tensor  # f32 — Σ hidden episode performances
    length_sum: torch.Tensor  # f32 — Σ episode lengths
    env_steps: torch.Tensor   # f32 — env transitions taken

    @staticmethod
    def zero(device) -> "ChunkStats":
        return ChunkStats(*(torch.zeros((), dtype=torch.float32, device=device)
                            for _ in range(5)))

    def accumulate(self, out: Dict[str, torch.Tensor]) -> "ChunkStats":
        """Add one engine step's finished episodes."""
        d = out["done"].to(torch.float32)
        return ChunkStats(
            episodes=self.episodes + d.sum(),
            return_sum=self.return_sum + (d * out["finished_return"]).sum(),
            hidden_sum=self.hidden_sum + (d * out["finished_hidden"]).sum(),
            length_sum=self.length_sum + (d * out["finished_len"].to(torch.float32)).sum(),
            env_steps=self.env_steps + d.shape[0],
        )

    def merge(self, other: "ChunkStats") -> "ChunkStats":
        return ChunkStats(*(getattr(self, f.name) + getattr(other, f.name)
                            for f in dataclasses.fields(self)))


def stats_to_host(stats: ChunkStats) -> Dict[str, float]:
    eps = float(stats.episodes)
    if eps == 0.0:
        # No episode finished in the window (e.g. a greedy policy that never
        # terminates inside --eval-steps): report the means as MISSING, not
        # 0.0 — a genuine zero return must stay distinguishable in the logs.
        mean = float("nan")
        return {
            "episodes": 0.0,
            "mean_return": mean,
            "mean_hidden": mean,
            "mean_length": mean,
            "env_steps": float(stats.env_steps),
        }
    return {
        "episodes": eps,
        "mean_return": float(stats.return_sum) / eps,
        "mean_hidden": float(stats.hidden_sum) / eps,
        "mean_length": float(stats.length_sum) / eps,
        "env_steps": float(stats.env_steps),
    }


def reward_source(out: Dict[str, torch.Tensor], cheat: bool) -> torch.Tensor:
    """The observed reward, or the hidden one under ``--cheat`` (a debugging
    upper bound that trains on the true reward)."""
    return out["hidden_reward"] if cheat else out["reward"]


def engine_step(vec, vstate, actions: torch.Tensor, generator=None):
    """One step of either engine, its draws from ``generator``: the compiled
    ``VecEnv`` takes a stochastic env's mechanics as ``draw_mechanics``'s
    tensors, the array engine draws through the env's own methods."""
    if isinstance(vec, VecEnv):
        draws = None
        if vec.stochastic:
            draws = tuple(d[0] for d in vec.draw_mechanics(generator, 1))
        return vec.step(vstate, actions, draws)
    return vec.step(vstate, actions, generator=generator)


def eval_chunk(
    vec,
    act_fn: Callable[[Any, Any], torch.Tensor],
    astate: Any,
    vstate: Any,
    n_steps: int,
    min_episodes: int | None = None,
    generator=None,
) -> Tuple[Any, ChunkStats]:
    """Greedy rollout: ``act_fn(astate, vstate)`` picks each step's actions.

    ``min_episodes=None`` runs ``n_steps`` steps. ``min_episodes=E`` steps
    until at least E episodes have finished, bounded by ``n_steps`` (the
    caller sizes the bound so the target is reachable through the episode
    timeout); that check reads the episode count on the host every step.
    ``vec`` is either engine (``engine_step``); a stochastic env's per-step
    draws come from ``generator``."""
    stats = ChunkStats.zero(vec.device)
    for _ in range(n_steps):
        if min_episodes is not None and float(stats.episodes) >= min_episodes:
            break
        vstate, out = engine_step(vec, vstate, act_fn(astate, vstate), generator)
        stats = stats.accumulate(out)
    return vstate, stats
