"""n-step replay windows over a collected chunk.

Counterpart of ``push_traj_windows`` (with ``_flat``) in
``safe_grid_agents_tpu/training/dqn.py``: a ``[T, N]`` chunk trajectory is
post-processed into window sums Rₜ⁽ⁿ⁾ = Σⱼ γʲ rₜ₊ⱼ, truncated at the first
done (auto-reset means rewards past a done belong to the next episode),
bootstrapping from sₜ₊ₙ with γⁿ; the windows are pushed time-major. The last
n − 1 steps of each chunk have no full window and are dropped. With n = 1
the pushed stream is bitwise the per-step push.

The ``VecEnv`` trainer of that file (``DQNTrainer``) is not ported yet
(ROADMAP A.9); the fused trainer (``training/dqn_fused.py``) uses this.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import replay


def _flat(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """[T, N, ...] → [t_out·N, ...], the first t_out steps, time-major."""
    x = x[:t_out]
    return x.reshape((-1,) + tuple(x.shape[2:]))


def push_traj_windows(agent, buffer: replay.BufferState, traj) -> replay.BufferState:
    """Push ``traj`` = (states, actions, rewards, next_states, dones) as
    n-step windows; states are ``TableState``s, every leaf ``[T, N]``."""
    states, actions, rewards, next_states, dones = traj
    n = agent.n_step
    t_total = actions.shape[0]
    if n > t_total:
        raise ValueError(f"n_step={n} exceeds chunk length {t_total}")
    t_out = t_total - n + 1
    ret = torch.zeros_like(rewards[:t_out])
    alive = torch.ones_like(rewards[:t_out])
    for j in range(n):
        ret = ret + (float(np.float32(agent.discount ** j)) * alive) * rewards[j:j + t_out]
        alive = alive * (1.0 - dones[j:j + t_out].to(ret.dtype))
    batch = replay.Transition(
        s_idx=_flat(states.idx, t_out),
        s_t=_flat(states.t, t_out),
        action=_flat(actions, t_out),
        reward=_flat(ret, t_out),
        # sₜ₊ₙ is the (n−1)th step's successor; where a done cut the window
        # the bootstrap is masked by done anyway.
        n_idx=_flat(next_states.idx[n - 1:], t_out),
        n_t=_flat(next_states.t[n - 1:], t_out),
        done=_flat(alive == 0.0, t_out),
    )
    return replay.push_batch(buffer, batch)
