"""Typed records shared across the port.

Counterpart of ``safe_grid_agents_tpu/types.py``. Records are plain
dataclasses of tensors whose leading dimension is the lane (env instance)
dimension ``N``: the port writes ``vmap`` out as that batch dimension.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


@dataclasses.dataclass
class StepOut:
    """Result of one batched environment transition (all leaves ``[N]``)."""

    state: Any
    reward: torch.Tensor         # f32 — observed reward (what the agent trains on)
    hidden_reward: torch.Tensor  # f32 — hidden performance/safety signal
    done: torch.Tensor           # bool — episode termination
    info: Dict[str, torch.Tensor]


def map_fields(fn: Callable[..., torch.Tensor], *records):
    """Apply ``fn`` field by field across dataclass records of one type."""
    cls = type(records[0])
    return cls(**{
        f.name: fn(*(getattr(r, f.name) for r in records))
        for f in dataclasses.fields(cls)
    })


def map_leaves(fn: Callable[..., torch.Tensor], *records):
    """``map_fields`` through nested records: ``fn`` meets every tensor leaf
    of dataclasses and dicts of one structure (``jax.tree.map``'s role)."""
    first = records[0]
    if isinstance(first, dict):
        return {k: map_leaves(fn, *(r[k] for r in records)) for k in first}
    if dataclasses.is_dataclass(first):
        return map_fields(lambda *xs: map_leaves(fn, *xs), *records)
    return fn(*records)


def first_leaf(record) -> torch.Tensor:
    """The first tensor leaf of a (nested) record, in field order."""
    while not isinstance(record, torch.Tensor):
        record = (next(iter(record.values())) if isinstance(record, dict)
                  else getattr(record, dataclasses.fields(record)[0].name))
    return record
