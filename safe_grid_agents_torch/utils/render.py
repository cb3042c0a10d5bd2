"""Board rendering: char-id boards to ANSI text or RGB arrays.

Counterpart of ``safe_grid_agents_tpu/utils/render.py`` (the reference gym
wrapper's ``render(mode=...)``), with its own copy of the palette. Boards
are the envs' ``board`` rows (``envs/grid.py::CHARS`` ids), as numpy
arrays or tensors.
"""
from __future__ import annotations

import numpy as np

from ..envs.grid import CHARS

_ID_TO_CHAR = {v: k for k, v in CHARS.items()}

# Palette of rgb_array mode (uint8).
_PALETTE = {
    " ": (30, 30, 30),
    "#": (120, 120, 120),
    "A": (50, 120, 250),
    "G": (50, 220, 80),
    "L": (240, 80, 30),
    "W": (40, 90, 200),
    "X": (170, 120, 60),
    ">": (200, 200, 60), "v": (200, 200, 60),
    "<": (200, 200, 60), "^": (200, 200, 60),
    "t": (140, 70, 40),
    "T": (220, 60, 60),
    "O": (200, 60, 200),
    "I": (250, 160, 30),
    "B": (250, 230, 40),
    "P": (250, 40, 40),
    "S": (230, 230, 230),
    "C": (180, 40, 180),
    "V": (160, 160, 220),
    "F": (220, 180, 60),
    "b": (90, 90, 110),
}


def _numpy(board) -> np.ndarray:
    if hasattr(board, "detach"):
        board = board.detach().cpu().numpy()
    return np.asarray(board)


def to_ansi(board) -> str:
    """int8 ``[H, W]`` char-id board → multi-line ASCII string."""
    return "\n".join("".join(_ID_TO_CHAR.get(int(c), "?") for c in row)
                     for row in _numpy(board))


def to_rgb(board, scale: int = 8) -> np.ndarray:
    """int8 ``[H, W]`` board → uint8 ``[H*scale, W*scale, 3]`` image."""
    board = _numpy(board)
    h, w = board.shape
    img = np.zeros((h, w, 3), np.uint8)
    for i in range(h):
        for j in range(w):
            img[i, j] = _PALETTE.get(_ID_TO_CHAR.get(int(board[i, j]), " "), (0, 0, 0))
    return np.kron(img, np.ones((scale, scale, 1), np.uint8))
