"""Environment registry.

Counterpart of ``safe_grid_agents_tpu/envs/__init__.py``. The port has the
shift family, ``sokoban``, ``island`` and the eight stochastic aliases
(absent, interrupt, whisky, tomato, tomato-crmdp, friend, foe, neutral);
every other alias of the JAX registry is known here and raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Callable, Dict

from .absent_supervisor import AbsentSupervisor
from .base import Env
from .distributional_shift import DistributionalShift
from .friend_foe import BoundedFriendFoe, FriendFoe
from .interruptibility import SafeInterruptibility
from .island_navigation import IslandNavigation
from .sokoban import Sokoban
from .tomato import TomatoCRMDP, TomatoWatering
from .whisky_gold import WhiskyGold

ENV_REGISTRY: Dict[str, Callable[..., Env]] = {
    "shift": DistributionalShift,
    "shift-test": lambda: DistributionalShift(testing=True),
    "sokoban": Sokoban,
    "island": IslandNavigation,
    "tomato": TomatoWatering,
    "tomato-crmdp": TomatoCRMDP,
    "whisky": WhiskyGold,
    "absent": AbsentSupervisor,
    "interrupt": SafeInterruptibility,
    "friend": lambda: FriendFoe(variant="friend"),
    "foe": lambda: FriendFoe(variant="foe"),
    "neutral": lambda: FriendFoe(variant="neutral"),
}

# Aliases whose array env has unbounded cross-episode state compile through
# an equivalent-within-bound substitute (envs/friend_foe.py), built directly;
# keyword arguments such as ``cap`` go to it.
COMPILE_SUBSTITUTE: Dict[str, Callable[..., Env]] = {
    v: (lambda v=v, **kw: BoundedFriendFoe(variant=v, **kw))
    for v in ("friend", "foe", "neutral")
}

# Aliases of the JAX registry that later slices port (ROADMAP queue A).
UNPORTED_ENVS: Dict[str, str] = {
    a: "A.8 (other deterministic aliases)" for a in (
        "sokoban2", "boat", "conveyor", "conveyor-sushi", "corners", "way", "toy",
    )
}

ALL_ENV_ALIASES = sorted([*ENV_REGISTRY, *UNPORTED_ENVS])


def make_env(alias: str, compiled: bool = False, device=None, **kwargs) -> Env:
    """Build an env by alias. ``compiled=True`` lowers it to the lookup-table
    engine (envs/compiled.py): the tables are built on the CPU and moved to
    ``device`` (default ``cuda:0``, no fallback) once. The friend family
    compiles through ``BoundedFriendFoe`` (``cap`` defaults to 127)."""
    if alias in UNPORTED_ENVS:
        raise NotImplementedError(
            f"env alias {alias!r} is not ported yet (ROADMAP {UNPORTED_ENVS[alias]})"
        )
    if alias not in ENV_REGISTRY:
        raise KeyError(f"unknown env alias {alias!r}; known: {ALL_ENV_ALIASES}")
    if not compiled:
        return ENV_REGISTRY[alias](**kwargs)
    from .compiled import compile_env

    build = COMPILE_SUBSTITUTE.get(alias, ENV_REGISTRY[alias])
    return compile_env(build(**kwargs), device)
