"""PPO's advantage estimate and whitening.

Counterpart of ``safe_grid_agents_tpu/training/ppo.py::_whiten`` and
``compute_gae``. The base ``PPOTrainer`` over the array engine is not
ported yet (ROADMAP A.10); the port's PPO trainers are
``training/ppo_mxu.py::MXUPPOTrainer`` and
``training/ppo_fused.py::FusedPPOTrainer``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def whiten(x: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit scale: ``(x − E[x]) / (sqrt(max(E[x²] − E[x]², 0)) +
    1e-8)``. The variance is the population one, as the reference takes
    it (not ``torch.std``, which is unbiased)."""
    m = x.mean()
    m2 = torch.square(x).mean()
    var = torch.clamp(m2 - torch.square(m), min=0.0)
    return (x - m) / (torch.sqrt(var) + 1e-8)


def compute_gae(rewards, values, dones, last_value, discount: float,
                lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[T, N]`` inputs → ``(advantages, returns)``, GAE(λ) by a reverse
    loop. Every ``done`` is terminal, timeouts included, as in the
    reference: the bootstrap and the running estimate are masked there."""
    gae = torch.zeros_like(last_value)
    next_value = last_value
    adv = torch.empty_like(values)
    for s in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[s].to(torch.float32)
        delta = rewards[s] + discount * nonterm * next_value - values[s]
        gae = delta + discount * lam * nonterm * gae
        adv[s] = gae
        next_value = values[s]
    return adv, adv + values
