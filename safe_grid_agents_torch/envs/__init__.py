"""Environment registry.

Counterpart of ``safe_grid_agents_tpu/envs/__init__.py``. The port has the
shift family and ``sokoban``; every other alias of the JAX registry is known
here and raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Callable, Dict

from .base import Env
from .distributional_shift import DistributionalShift
from .sokoban import Sokoban

ENV_REGISTRY: Dict[str, Callable[..., Env]] = {
    "shift": DistributionalShift,
    "shift-test": lambda: DistributionalShift(testing=True),
    "sokoban": Sokoban,
}

# Aliases of the JAX registry that later slices port (ROADMAP queue A).
UNPORTED_ENVS: Dict[str, str] = {
    **{a: "A.8 (other deterministic aliases)" for a in (
        "island", "sokoban2", "boat", "conveyor", "conveyor-sushi",
        "corners", "way", "toy",
    )},
    **{a: "A.11 (stochastic aliases)" for a in (
        "tomato", "tomato-crmdp", "whisky", "absent", "interrupt",
        "friend", "foe", "neutral",
    )},
}

ALL_ENV_ALIASES = sorted([*ENV_REGISTRY, *UNPORTED_ENVS])


def make_env(alias: str, compiled: bool = False, device=None) -> Env:
    """Build an env by alias. ``compiled=True`` lowers it to the lookup-table
    engine (envs/compiled.py): the tables are built on the CPU and moved to
    ``device`` (default ``cuda:0``, no fallback) once."""
    if alias in UNPORTED_ENVS:
        raise NotImplementedError(
            f"env alias {alias!r} is not ported yet (ROADMAP {UNPORTED_ENVS[alias]})"
        )
    if alias not in ENV_REGISTRY:
        raise KeyError(f"unknown env alias {alias!r}; known: {ALL_ENV_ALIASES}")
    env = ENV_REGISTRY[alias]()
    if compiled:
        from .compiled import compile_env

        return compile_env(env, device)
    return env
