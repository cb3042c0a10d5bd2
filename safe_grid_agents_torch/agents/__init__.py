"""Agent registry — counterpart of ``safe_grid_agents_tpu/agents/__init__.py``.

The port has every alias of the reference: ``random``, ``single``, ``tabular-q``,
``deep-q``, ``ppo-mlp``, ``ppo-cnn`` and ``ppo-crmdp``.
"""
from __future__ import annotations

from typing import Callable, Dict

from .base import Agent
from .crmdp import PPOCRMDPAgent
from .dqn import DQNAgent
from .dummy import RandomAgent, SingleActionAgent
from .ppo import PPOAgent, PPOCNNAgent
from .tabular import TabularQAgent

AGENT_REGISTRY: Dict[str, Callable[..., Agent]] = {
    "random": RandomAgent,
    "single": SingleActionAgent,
    "tabular-q": TabularQAgent,
    "deep-q": DQNAgent,
    "ppo-mlp": PPOAgent,
    "ppo-cnn": PPOCNNAgent,
    "ppo-crmdp": PPOCRMDPAgent,
}

ALL_AGENT_ALIASES = sorted(AGENT_REGISTRY)


def make_agent(alias: str, env, **kwargs) -> Agent:
    if alias not in AGENT_REGISTRY:
        raise KeyError(f"unknown agent alias {alias!r}; known: {ALL_AGENT_ALIASES}")
    return AGENT_REGISTRY[alias](env, **kwargs)
