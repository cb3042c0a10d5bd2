"""Agent contract.

Counterpart of ``safe_grid_agents_tpu/agents/base.py``: an agent object is
static configuration bound to an env; its mutable quantities live in an
agent-state record that the trainers pass around. All act/learn methods are
batched over N lanes.
"""
from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from ..envs.base import Env


def f32(x: float, device) -> torch.Tensor:
    """``x`` rounded to a float32 scalar tensor, as JAX rounds a Python
    float that meets a float32 array."""
    return torch.tensor(float(np.float32(x)), dtype=torch.float32, device=device)


def linear_epsilon(step: torch.Tensor, start: float, final: float,
                   horizon: float) -> torch.Tensor:
    """The agents' linear ε anneal in float32, as the reference computes it
    (``final − start`` taken in double, then rounded)."""
    dev = step.device
    frac = (step.to(torch.float32) / f32(horizon, dev)).clamp(0.0, 1.0)
    return f32(start, dev) + frac * f32(final - start, dev)


def obs_dim(env) -> int:
    """``P·H·W``: the flat width of one observation, the nets' input width
    on any env (a compiled env's observation table rows have it too)."""
    P, H, W = env.obs_shape
    return P * H * W


def explore_draws(n: int, n_actions: int, generator=None, device=None):
    """One ε-greedy step's draws for ``n`` lanes: ``rand_a`` ``[N]`` int32
    in ``[0, A)``, then ``u`` ``[N]`` f32 uniform (the JAX agents split the
    key into a ``randint`` and a ``bernoulli``, which is ``uniform < p``)."""
    rand_a = torch.randint(0, n_actions, (n,), dtype=torch.int32, generator=generator,
                           device=device)
    u = torch.rand((n,), dtype=torch.float32, generator=generator, device=device)
    return rand_a, u


def epsilon_greedy(greedy: torch.Tensor, rand_a: torch.Tensor, u: torch.Tensor,
                   epsilon: torch.Tensor) -> torch.Tensor:
    """The random action where ``u < ε``, else the greedy one."""
    return torch.where(u < epsilon, rand_a.to(greedy.dtype), greedy)


class Agent:
    """Base: static config + functions over (agent state, batch)."""

    name: str = "agent"

    def __init__(self, env: Env):
        self.env = env

    def init(self, device=None) -> Any:
        """Build the initial agent state (tables, params...) on ``device``."""
        raise NotImplementedError

    def act(self, astate: Any, env_states: Any) -> torch.Tensor:
        """Greedy actions ``[N]`` for batched env states."""
        raise NotImplementedError

    def for_env(self, env: Env) -> "Agent":
        """A shallow copy bound to a different, shape-compatible env: the
        distributional-shift protocol trains on one layout and evaluates on
        the shifted one, whose state indexing must be the eval env's."""
        c = copy.copy(self)
        c.env = env
        return c
