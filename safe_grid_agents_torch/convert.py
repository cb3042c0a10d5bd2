"""Carry state between the JAX package and the port, as numpy arrays.

The port never imports JAX: a caller holding JAX arrays passes
``np.asarray(x)`` in and gets numpy arrays back, so one computation can run
in both packages from identical inputs. Three kinds of state cross:

* tabular-Q state — ``q [S, A]`` f32 and the global step counter;
* the engines' carried 5-tuple ``(idx, t, ep_return, ep_hidden, ep_len)``,
  each ``(1, N)``;
* a compiled env's tables, by the JAX attribute names.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .agents.tabular import TabularQState
from .device import resolve_device

ENGINE_DTYPES = (np.int32, np.int32, np.float32, np.float32, np.int32)
TABLE_NAMES = ("next_table", "reward_table", "hidden_table", "done_table",
               "reachable", "obs_table", "board_table")


def tabular_state_from_numpy(q, step, device=None) -> TabularQState:
    dev = resolve_device(device)
    return TabularQState(
        q=torch.as_tensor(np.array(q, np.float32), device=dev),
        step=torch.tensor(int(step), dtype=torch.int64, device=dev),
    )


def tabular_state_to_numpy(astate: TabularQState) -> Tuple[np.ndarray, int]:
    return astate.q.detach().cpu().numpy(), int(astate.step)


def engine_state_from_numpy(state, device=None) -> Tuple[torch.Tensor, ...]:
    """5 arrays of ``N`` or ``(1, N)`` values → 5 ``(1, N)`` tensors."""
    dev = resolve_device(device)
    if len(state) != 5:
        raise ValueError(f"engine state: expected 5 arrays, got {len(state)}")
    return tuple(
        torch.as_tensor(np.array(x, d).reshape(1, -1), device=dev)
        for x, d in zip(state, ENGINE_DTYPES)
    )


def engine_state_to_numpy(state) -> Tuple[np.ndarray, ...]:
    return tuple(x.detach().cpu().numpy() for x in state)


def tables_to_numpy(cenv) -> Dict[str, np.ndarray]:
    """A compiled env's tables (and info tables, as ``info/<key>``)."""
    out = {n: getattr(cenv, n).cpu().numpy() for n in TABLE_NAMES}
    out.update({f"info/{k}": v.cpu().numpy() for k, v in cenv.info_tables.items()})
    return out


def tables_from_numpy(tables: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in tables.items()}
