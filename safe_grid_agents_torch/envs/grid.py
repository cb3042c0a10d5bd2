"""Shared grid mechanics, batched over lanes.

Counterpart of ``safe_grid_agents_tpu/envs/grid.py``: the same action enum,
deltas and char palette, with ``move`` written over ``[N, 2]`` positions.

Canonical action enum: UP=0, DOWN=1, LEFT=2, RIGHT=3.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3
N_ACTIONS = 4

# Row/col deltas indexed by action.
DELTAS = np.array([[-1, 0], [1, 0], [0, -1], [0, 1]], dtype=np.int32)

# Global char palette: boards render cell-type ids from this table, so every
# env shares one integer encoding (kept identical to the JAX package's).
CHARS: Dict[str, int] = {
    " ": 0,   # floor
    "#": 1,   # wall
    "A": 2,   # agent
    "G": 3,   # goal
    "L": 4,   # lava
    "W": 5,   # water / whisky (env-scoped meaning)
    "X": 6,   # sokoban box
    ">": 7,   # boat-race checkpoint (rightward)
    "v": 8,   # boat-race checkpoint (downward)
    "<": 9,   # boat-race checkpoint (leftward)
    "^": 10,  # boat-race checkpoint (upward)
    "t": 11,  # dry tomato
    "T": 12,  # watered tomato
    "O": 13,  # observation-corrupting bucket tile
    "I": 14,  # interruption tile
    "B": 15,  # interruption-disabling button
    "P": 16,  # punishment tile
    "S": 17,  # supervisor marker
    "C": 18,  # corrupt-reward cell (toy CRMDP worlds)
    "V": 19,  # conveyor object (vase/sushi)
    "F": 20,  # friend-foe reward box
    "b": 21,  # conveyor belt tile
}


def parse_art(art: List[str]) -> Tuple[np.ndarray, Dict[str, List[Tuple[int, int]]]]:
    """Parse ASCII art into (char-id grid, positions-by-char).

    Returns the static board as int8 ids (agent char included where drawn)
    and a dict mapping each non-floor char to its list of (row, col) cells.
    """
    h, w = len(art), len(art[0])
    grid = np.zeros((h, w), dtype=np.int8)
    where: Dict[str, List[Tuple[int, int]]] = {}
    for r, row in enumerate(art):
        if len(row) != w:
            raise ValueError(f"ragged art row {r}")
        for c, ch in enumerate(row):
            grid[r, c] = CHARS[ch]
            if ch != " ":
                where.setdefault(ch, []).append((r, c))
    return grid, where


def move(pos: torch.Tensor, action: torch.Tensor, passable: torch.Tensor) -> torch.Tensor:
    """Propose pos+delta per lane; stay in place where the target cell is
    impassable.

    ``pos`` is ``[N, 2]`` int32 (row, col), ``action`` ``[N]`` integer and
    ``passable`` a static ``[H, W]`` bool map on the same device. Boards
    have wall borders, so the proposed cell is always in bounds.
    """
    deltas = torch.as_tensor(DELTAS, device=pos.device)
    nxt = pos + deltas[action.long()]
    ok = passable[nxt[:, 0].long(), nxt[:, 1].long()]
    return torch.where(ok[:, None], nxt, pos)


def at_cell(pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[N]`` bool: True where ``pos`` lies on a cell of the static mask."""
    return mask[pos[:, 0].long(), pos[:, 1].long()]


def same_pos(pos: torch.Tensor, cell) -> torch.Tensor:
    """``[N]`` bool: True where ``pos`` equals the static ``(row, col)``."""
    return (pos == torch.as_tensor(cell, device=pos.device)).all(-1)


def coins(n: int, generator=None, device=None, p: float = 0.5) -> torch.Tensor:
    """``[N]`` bool draws, True with probability ``p`` (one uniform each)."""
    return torch.rand(n, generator=generator, device=device) < p
