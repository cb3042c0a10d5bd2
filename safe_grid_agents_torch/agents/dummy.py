"""Baseline agents: random and single-action.

Counterpart of ``safe_grid_agents_tpu/agents/dummy.py``: they learn
nothing and sanity-check the envs and the metric plumbing.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..types import first_leaf
from .base import Agent


@dataclasses.dataclass
class DummyState:
    step: torch.Tensor  # 0-d i64 — kept so that every trainer's state has one


class RandomAgent(Agent):
    name = "random"

    def init(self, device=None) -> DummyState:
        return DummyState(step=torch.zeros((), dtype=torch.int64,
                                           device=resolve_device(device)))

    def act(self, astate: DummyState, env_states, generator=None) -> torch.Tensor:
        """Uniform actions ``[N]`` drawn from ``generator``."""
        dev = astate.step.device
        return torch.randint(0, self.env.n_actions, (first_leaf(env_states).shape[0],),
                             dtype=torch.int32, generator=generator, device=dev)

    act_explore = act


class SingleActionAgent(Agent):
    name = "single"

    def __init__(self, env, action: int = 0):
        super().__init__(env)
        self.action = action

    def init(self, device=None) -> DummyState:
        return DummyState(step=torch.zeros((), dtype=torch.int64,
                                           device=resolve_device(device)))

    def act(self, astate: DummyState, env_states, generator=None) -> torch.Tensor:
        del generator
        return torch.full((first_leaf(env_states).shape[0],), self.action, dtype=torch.int32,
                          device=astate.step.device)

    act_explore = act
