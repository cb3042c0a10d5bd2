"""The array engine: N lockstep instances of any env, auto-reset inside the
step, episode accounting.

Counterpart of ``safe_grid_agents_tpu/envs/vec.py::VecEnv`` (the port's
``envs/vec.py::VecEnv`` is the compiled engine, the counterpart of
``MXUVecEnv``). It steps the env's own batched methods, so one engine runs
the uncompiled envs and a ``CompiledEnv`` (``--compiled`` without
``--mxu``) alike; the state it carries is the env's state record, whatever
its fields.

A step advances every lane, then resets the lanes whose episode ended with
the env's carried reset (the friend family keeps its choice counts across
the boundary; every other env starts afresh) and reports the finished
episode's statistics on that boundary. It returns, per lane, ``reward /
hidden_reward / done / info / finished_return / finished_hidden /
finished_len`` (``finished_*`` valid where ``done``) and ``pre_reset_env``,
the successor state before the reset: the state a learner bootstraps from
or indexes.

Randomness. The JAX engine gives each lane a key and splits it into a step
key and a reset key every step; here a step's draws come either from a
``torch.Generator`` (the env's own ``step`` and ``carry_reset``, in that
order) or, handed over as tensors, in ``draws``:

* ``coin`` ``[N]`` — the reset coin of the coin-reset envs (absent's
  supervisor, interrupt's arming, the friend family's tie-break), read by
  ``reset_from_coin`` / ``carry_reset_from_coin`` on the lanes that reset;
* the env's ``draw_step`` entries — whisky's ``stumble`` and
  ``rand_action``, tomato's ``dry`` — read by ``step_from_draws``.

An env whose reset draws nothing resets to one state, built once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..types import map_fields, map_leaves
from .base import Env
from .compiled import CompiledEnv


@dataclasses.dataclass
class VecState:
    env: Any                 # the env's state record, fields [N, ...]
    ep_return: torch.Tensor  # [N] f32 running observed return
    ep_hidden: torch.Tensor  # [N] f32 running hidden performance
    ep_len: torch.Tensor     # [N] i32 running episode length


def select(mask: torch.Tensor, on_true, on_false):
    """Lane-wise ``where`` over two state records; ``mask`` is ``[N]``."""
    def pick(a, b):
        return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
    return map_fields(pick, on_true, on_false)


class ArrayVecEnv:
    """N lockstep instances of ``env`` (module doc)."""

    def __init__(self, env: Env, n_envs: int, device=None):
        self.env = env
        self.n_envs = n_envs
        compiled = isinstance(env, CompiledEnv)
        self.device = env.device if compiled else resolve_device(device)
        base = env.base if compiled else env
        self.compiled = compiled
        self.coin_reset = hasattr(base, "reset_from_coin")
        self.carried = hasattr(base, "carry_reset_from_coin")
        self.step_draws = hasattr(base, "draw_step")
        self.stochastic = self.coin_reset or self.step_draws
        # A reset that draws nothing gives every lane the same state.
        self._fresh = None if self.coin_reset else env.reset(n_envs, device=self.device)

    # -- reset -----------------------------------------------------------------
    def reset(self, generator=None, coin: Optional[torch.Tensor] = None) -> VecState:
        """Fresh lanes; a coin-reset env draws its ``[N]`` coins from
        ``generator`` unless ``coin`` is given."""
        n, dev = self.n_envs, self.device
        if not self.coin_reset:
            env_state = map_fields(torch.clone, self._fresh)
        elif coin is not None:
            env_state = self.env.reset_from_coin(coin)
        else:
            env_state = self.env.reset(n, generator, device=dev)
        z = torch.zeros(n, dtype=torch.float32, device=dev)
        return VecState(env=env_state, ep_return=z, ep_hidden=z.clone(),
                        ep_len=torch.zeros(n, dtype=torch.int32, device=dev))

    # -- step ------------------------------------------------------------------
    def _env_step(self, state, actions, draws, generator):
        if draws is None or not self.step_draws:
            return self.env.step(state, actions, generator)
        step_draws = {k: v for k, v in draws.items() if k != "coin"}
        if self.compiled:
            return self.env.step(state, actions, draws=step_draws)
        return self.env.step_from_draws(state, actions, **step_draws)

    def _reset_like(self, successor, draws, generator):
        if not self.coin_reset:
            return self._fresh
        if draws is None:
            if self.carried:
                return self.env.carry_reset(successor, generator)
            return self.env.reset(self.n_envs, generator, device=self.device)
        if self.carried:
            return self.env.carry_reset_from_coin(successor, draws["coin"])
        return self.env.reset_from_coin(draws["coin"])

    def step(self, vstate: VecState, actions: torch.Tensor,
             draws: Optional[Dict[str, torch.Tensor]] = None, generator=None
             ) -> Tuple[VecState, Dict[str, Any]]:
        """One step of every lane with auto-reset (module doc)."""
        out = self._env_step(vstate.env, actions, draws, generator)
        reset = self._reset_like(out.state, draws, generator)
        done = out.done
        ep_return = vstate.ep_return + out.reward
        ep_hidden = vstate.ep_hidden + out.hidden_reward
        ep_len = vstate.ep_len + 1
        new = VecState(
            env=select(done, reset, out.state),
            ep_return=torch.where(done, torch.zeros_like(ep_return), ep_return),
            ep_hidden=torch.where(done, torch.zeros_like(ep_hidden), ep_hidden),
            ep_len=torch.where(done, torch.zeros_like(ep_len), ep_len),
        )
        return new, dict(
            reward=out.reward,
            hidden_reward=out.hidden_reward,
            done=done,
            info=out.info,
            finished_return=ep_return,
            finished_hidden=ep_hidden,
            finished_len=ep_len,
            pre_reset_env=out.state,
        )

    # -- views -----------------------------------------------------------------
    def observe(self, vstate: VecState) -> torch.Tensor:
        """``[N, P, H, W]`` observation planes of the current states."""
        return self.env.observe(vstate.env)

    def board(self, vstate: VecState) -> torch.Tensor:
        return self.env.board(vstate.env)

    def state_index(self, vstate: VecState) -> torch.Tensor:
        return self.env.state_index(vstate.env)

    # -- bulk stepping -----------------------------------------------------------
    def run_actions(self, vstate: VecState, actions_tn: torch.Tensor, draws=None
                    ) -> Tuple[VecState, Dict[str, Any]]:
        """Step a ``[T, N]`` action matrix (with ``draws``, a list of T
        per-step dicts); returns the outputs stacked over T."""
        outs = []
        for s, row in enumerate(actions_tn):
            vstate, out = self.step(vstate, row, None if draws is None else draws[s])
            outs.append(out)
        return vstate, stack_outs(outs)

    def _random_actions(self, generator) -> torch.Tensor:
        return torch.randint(0, self.env.n_actions, (self.n_envs,), dtype=torch.int32,
                             generator=generator, device=self.device)

    def run_random(self, vstate: VecState, generator, n_steps: int):
        """``n_steps`` uniform-random actions; each step draws its actions,
        then the env's draws, from ``generator``. Returns stacked outputs."""
        outs = []
        for _ in range(n_steps):
            vstate, out = self.step(vstate, self._random_actions(generator),
                                    generator=generator)
            outs.append(out)
        return vstate, stack_outs(outs)

    def run_random_reduced(self, vstate: VecState, generator, n_steps: int,
                           actions: Optional[torch.Tensor] = None
                           ) -> Tuple[VecState, Dict[str, torch.Tensor]]:
        """``run_random`` that keeps only the totals, on the device:
        ``reward_sum``, ``episodes`` and ``finished_return_sum``. The
        ``[T, N]`` ``actions`` may be handed over instead of drawn."""
        dev = self.device
        acc = {"reward_sum": torch.zeros((), dtype=torch.float32, device=dev),
               "episodes": torch.zeros((), dtype=torch.int32, device=dev),
               "finished_return_sum": torch.zeros((), dtype=torch.float32, device=dev)}
        for s in range(n_steps):
            row = self._random_actions(generator) if actions is None else actions[s]
            vstate, out = self.step(vstate, row, generator=generator)
            done = out["done"]
            acc["reward_sum"] = acc["reward_sum"] + out["reward"].sum()
            acc["episodes"] = acc["episodes"] + done.sum(dtype=torch.int32)
            acc["finished_return_sum"] = acc["finished_return_sum"] + torch.where(
                done, out["finished_return"], torch.zeros_like(out["finished_return"])).sum()
        return vstate, acc


def stack_outs(outs):
    """Per-step outputs (dicts, records, tensors) → one, stacked over T."""
    return map_leaves(lambda *xs: torch.stack(xs), *outs)
