"""Agent registry — counterpart of ``safe_grid_agents_tpu/agents/__init__.py``.

The port has ``tabular-q``, ``deep-q``, ``ppo-mlp`` and ``ppo-crmdp``; the other aliases
of the JAX registry are known here and raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""
from __future__ import annotations

from typing import Callable, Dict

from .base import Agent
from .crmdp import PPOCRMDPAgent
from .dqn import DQNAgent
from .ppo import PPOAgent
from .tabular import TabularQAgent

AGENT_REGISTRY: Dict[str, Callable[..., Agent]] = {
    "tabular-q": TabularQAgent,
    "deep-q": DQNAgent,
    "ppo-mlp": PPOAgent,
    "ppo-crmdp": PPOCRMDPAgent,
}

UNPORTED_AGENTS: Dict[str, str] = {
    "random": "A.13 (dummy agents)",
    "single": "A.13 (dummy agents)",
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
