"""Vectorized runtime over compiled tables: auto-reset and episode accounting.

Counterpart of ``safe_grid_agents_tpu/envs/vec.py`` together with the
deterministic contract of ``safe_grid_agents_tpu/envs/mxu.py::MXUVecEnv``
(the card has no MXU, so there is one engine: per-lane table gathers). N
lanes advance in lockstep; a lane whose episode ends is reset to the env's
single reset state inside the step, and the step reports the finished
episode's statistics on that boundary.

Only deterministic resets are ported here. An env whose reset support has
more than one state (absent, interrupt, the friend family) raises
``NotImplementedError``: its coin and carried resets come with the
stochastic slice (ROADMAP A.11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .compiled import CompiledEnv, TableState


@dataclasses.dataclass
class VecState:
    idx: torch.Tensor        # [N] i32 state index
    t: torch.Tensor          # [N] i32 episode step count
    ep_return: torch.Tensor  # [N] f32
    ep_hidden: torch.Tensor  # [N] f32
    ep_len: torch.Tensor     # [N] i32


class VecEnv:
    """N lockstep instances of a compiled env with a deterministic reset.

    ``step`` returns, per lane, ``reward / hidden_reward / done /
    finished_return / finished_hidden / finished_len / next_idx`` exactly as
    ``MXUVecEnv.step`` does (``finished_*`` valid where ``done``;
    ``next_idx`` is the pre-reset successor index)."""

    def __init__(self, cenv: CompiledEnv, n_envs: int):
        self.cenv = cenv
        self.n_envs = n_envs
        self.S, self.A = cenv.num_states, cenv.n_actions
        self.max_steps = int(cenv.max_steps)
        self.device = cenv.device

        # Reset support: carry_reset from a spread of reachable states under
        # several generators, and reset() under several more. One index →
        # the deterministic reset this engine runs.
        reach = cenv.reachable
        probe = reach[:: max(1, len(reach) // 8)]
        st = TableState(idx=probe, t=torch.zeros_like(probe))
        idxs = set()
        for k in range(4):
            out = cenv.carry_reset(st, torch.Generator().manual_seed(k))
            idxs.update(out.idx.tolist())
        for k in range(8):
            idxs.add(int(cenv.reset(1, torch.Generator().manual_seed(k)).idx[0]))
        if len(idxs) != 1:
            raise NotImplementedError(
                f"{cenv.name}: reset support {sorted(idxs)} is stochastic; "
                "coin and carried resets are not ported yet (ROADMAP A.11)"
            )
        self.reset_idx = idxs.pop()

    def reset(self, generator=None) -> VecState:
        del generator  # deterministic reset
        n, dev = self.n_envs, self.device
        z_i = torch.zeros(n, dtype=torch.int32, device=dev)
        z_f = torch.zeros(n, dtype=torch.float32, device=dev)
        return VecState(
            idx=torch.full((n,), self.reset_idx, dtype=torch.int32, device=dev),
            t=z_i, ep_return=z_f, ep_hidden=z_f.clone(), ep_len=z_i.clone(),
        )

    def step(self, state: VecState, actions: torch.Tensor) -> Tuple[VecState, Dict[str, torch.Tensor]]:
        c = self.cenv
        i, a = state.idx.long(), actions.long()
        nxt = c.next_table[i, a]
        reward = c.reward_table[i, a]
        hidden = c.hidden_table[i, a]
        t = state.t + 1
        done = c.done_table[i, a] | (t >= self.max_steps)
        ep_return = state.ep_return + reward
        ep_hidden = state.ep_hidden + hidden
        ep_len = state.ep_len + 1
        reset_idx = torch.full_like(nxt, self.reset_idx)
        new = VecState(
            idx=torch.where(done, reset_idx, nxt),
            t=torch.where(done, torch.zeros_like(t), t),
            ep_return=torch.where(done, torch.zeros_like(ep_return), ep_return),
            ep_hidden=torch.where(done, torch.zeros_like(ep_hidden), ep_hidden),
            ep_len=torch.where(done, torch.zeros_like(ep_len), ep_len),
        )
        out = dict(
            reward=reward,
            hidden_reward=hidden,
            done=done,
            finished_return=ep_return,
            finished_hidden=ep_hidden,
            finished_len=ep_len,
            next_idx=nxt,
        )
        return new, out

    def run_actions(self, state: VecState, actions_tn: torch.Tensor) -> Tuple[VecState, Dict[str, torch.Tensor]]:
        """Step through a ``[T, N]`` action matrix; returns stacked outs."""
        outs = []
        for row in actions_tn:
            state, out = self.step(state, row)
            outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
