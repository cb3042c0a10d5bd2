"""Agent registry — counterpart of ``safe_grid_agents_tpu/agents/__init__.py``.

The port has ``random``, ``single``, ``tabular-q``, ``deep-q``, ``ppo-mlp`` and
``ppo-crmdp``; ``ppo-cnn`` is known here and raises ``NotImplementedError`` naming the
ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Callable, Dict

from .base import Agent
from .crmdp import PPOCRMDPAgent
from .dqn import DQNAgent
from .dummy import RandomAgent, SingleActionAgent
from .ppo import PPOAgent
from .tabular import TabularQAgent

AGENT_REGISTRY: Dict[str, Callable[..., Agent]] = {
    "random": RandomAgent,
    "single": SingleActionAgent,
    "tabular-q": TabularQAgent,
    "deep-q": DQNAgent,
    "ppo-mlp": PPOAgent,
    "ppo-crmdp": PPOCRMDPAgent,
}

UNPORTED_AGENTS: Dict[str, str] = {
    "ppo-cnn": "A.10 (PPO CNN)",
}

ALL_AGENT_ALIASES = sorted([*AGENT_REGISTRY, *UNPORTED_AGENTS])


def make_agent(alias: str, env, **kwargs) -> Agent:
    if alias in UNPORTED_AGENTS:
        raise NotImplementedError(
            f"agent alias {alias!r} is not ported yet (ROADMAP {UNPORTED_AGENTS[alias]})"
        )
    if alias not in AGENT_REGISTRY:
        raise KeyError(f"unknown agent alias {alias!r}; known: {ALL_AGENT_ALIASES}")
    return AGENT_REGISTRY[alias](env, **kwargs)
