"""Environment base contract, batched over lanes.

Counterpart of ``safe_grid_agents_tpu/envs/base.py``. The JAX contract is
per instance and ``vmap``-ed; here every method takes and returns a leading
lane dimension ``N``:

* ``reset(n, generator=None, device=None) -> State``  — ``n`` fresh states
* ``step(state, action, generator=None) -> StepOut``  — pure transition
* ``observe(state) -> f32 [N, P, H, W]``              — one-hot plane stack
* ``board(state) -> int8 [N, H, W]``                  — char-id board render
* ``state_index(state) -> i32 [N]``                   — perfect hash for tabular Q

A step's randomness comes from the ``torch.Generator`` it is given (the JAX
package's per-step key); deterministic envs ignore it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..types import StepOut
from . import grid


class Env:
    """Base class. Subclasses are static configuration objects holding numpy
    spec arrays; their methods are functions of batched state tensors."""

    name: str = "env"
    n_actions: int = grid.N_ACTIONS
    height: int = 0
    width: int = 0
    n_planes: int = 0          # planes in observe()
    max_steps: int = 100
    # Dense tabular-Q state-space size, or None if not enumerable.
    num_states: Optional[int] = None

    # -- required ----------------------------------------------------------
    def reset(self, n: int, generator=None, device=None):
        raise NotImplementedError

    def step(self, state, action: torch.Tensor, generator=None) -> StepOut:
        raise NotImplementedError

    def observe(self, state) -> torch.Tensor:
        raise NotImplementedError

    def board(self, state) -> torch.Tensor:
        raise NotImplementedError

    # -- optional ----------------------------------------------------------
    def state_index(self, state) -> torch.Tensor:
        """Perfect hash of each lane's state into [0, num_states)."""
        raise NotImplementedError(f"{self.name} has no tabular state index")

    def carry_reset(self, state, generator=None):
        """Reset at auto-reset boundaries. Default: a plain reset of as many
        lanes as ``state`` holds, on its device."""
        idx = self.state_index(state)
        return self.reset(idx.shape[0], generator, device=idx.device)

    # -- helpers -----------------------------------------------------------
    @property
    def obs_shape(self):
        return (self.n_planes, self.height, self.width)

    def _timeout(self, t: torch.Tensor) -> torch.Tensor:
        """True where the post-step step count ``t`` hits the step limit."""
        return t >= self.max_steps
