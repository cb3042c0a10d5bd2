"""Environment registry.

Counterpart of ``safe_grid_agents_tpu/envs/__init__.py``: the same 19
aliases, each built by the same constructor call.
"""
from __future__ import annotations

from typing import Callable, Dict

from .absent_supervisor import AbsentSupervisor
from .base import Env
from .boat_race import BoatRace
from .conveyor_belt import ConveyorBelt
from .distributional_shift import DistributionalShift
from .friend_foe import BoundedFriendFoe, FriendFoe
from .interruptibility import SafeInterruptibility
from .island_navigation import IslandNavigation
from .sokoban import Sokoban
from .tomato import TomatoCRMDP, TomatoWatering
from .toy import ToyGridworld
from .whisky_gold import WhiskyGold

ENV_REGISTRY: Dict[str, Callable[..., Env]] = {
    "shift": DistributionalShift,
    "shift-test": lambda: DistributionalShift(testing=True),
    "island": IslandNavigation,
    "sokoban": Sokoban,
    "sokoban2": lambda: Sokoban(level=1),
    "boat": BoatRace,
    "tomato": TomatoWatering,
    "tomato-crmdp": TomatoCRMDP,
    "whisky": WhiskyGold,
    "absent": AbsentSupervisor,
    "interrupt": SafeInterruptibility,
    "conveyor": lambda: ConveyorBelt(variant="vase"),
    "conveyor-sushi": lambda: ConveyorBelt(variant="sushi"),
    "friend": lambda: FriendFoe(variant="friend"),
    "foe": lambda: FriendFoe(variant="foe"),
    "neutral": lambda: FriendFoe(variant="neutral"),
    "corners": lambda: ToyGridworld(variant="corners"),
    "way": lambda: ToyGridworld(variant="way"),
    "toy": lambda: ToyGridworld(variant="uncorrupted"),
}

# Aliases whose array env has unbounded cross-episode state compile through
# an equivalent-within-bound substitute (envs/friend_foe.py), built directly;
# keyword arguments such as ``cap`` go to it.
COMPILE_SUBSTITUTE: Dict[str, Callable[..., Env]] = {
    v: (lambda v=v, **kw: BoundedFriendFoe(variant=v, **kw))
    for v in ("friend", "foe", "neutral")
}

ALL_ENV_ALIASES = sorted(ENV_REGISTRY)


def make_env(alias: str, compiled: bool = False, device=None, **kwargs) -> Env:
    """Build an env by alias. ``compiled=True`` lowers it to the lookup-table
    engine (envs/compiled.py): the tables are built on the CPU and moved to
    ``device`` (default ``cuda:0``, no fallback) once. The friend family
    compiles through ``BoundedFriendFoe`` (``cap`` defaults to 127)."""
    if alias not in ENV_REGISTRY:
        raise KeyError(f"unknown env alias {alias!r}; known: {ALL_ENV_ALIASES}")
    if not compiled:
        return ENV_REGISTRY[alias](**kwargs)
    from .compiled import compile_env

    build = COMPILE_SUBSTITUTE.get(alias, ENV_REGISTRY[alias])
    return compile_env(build(**kwargs), device)
