"""Vectorized runtime over compiled tables: auto-reset and episode accounting.

Counterpart of ``safe_grid_agents_tpu/envs/vec.py`` together with the
contract of ``safe_grid_agents_tpu/envs/mxu.py::MXUVecEnv`` (the card has no
MXU, so there is one engine: per-lane table gathers). N lanes advance in
lockstep; a lane whose episode ends is reset inside the step, and the step
reports the finished episode's statistics on that boundary.

The reset and the per-step randomness follow ``MXUVecEnv``'s analysis,
derived here from the base env's draw-taking forms instead of by probing
keys:

* mode 0 — one reset state (``reset_idx``);
* mode 1 — a coin picks ``reset_idx_bit[0]`` or ``[1]`` (absent's
  supervisor, interrupt's arming: ``reset_from_coin``);
* mode 2 — carried resets (the friend family: ``carry_reset_from_coin``):
  two ``[S]`` carry tables, one per coin, composed with ``next_table`` into
  the per-(s, a) candidates ``cand0``/``cand1`` of the successor;
* whisky's stumble reads the drunk row (``state_store.drunk``);
* tomato's drying clears the dried watered bits of the index,
  ``idx − (idx & (2^K − 1) & bits)``, before the gathers.

A step takes its draws as ``[N]`` int32 arguments ``(bits, stumble,
rand_a)``: ``bits`` is the reset coin (modes 1, 2) or tomato's K dry coins
packed little-endian; ``stumble``/``rand_a`` are whisky's. Drying comes only
with a deterministic reset and no noise, so the two uses of ``bits`` never
meet. ``draw_mechanics`` draws them from a generator in that order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import grid
from .compiled import CompiledEnv, TableState


@dataclasses.dataclass
class VecState:
    idx: torch.Tensor        # [N] i32 state index
    t: torch.Tensor          # [N] i32 episode step count
    ep_return: torch.Tensor  # [N] f32
    ep_hidden: torch.Tensor  # [N] f32
    ep_len: torch.Tensor     # [N] i32


@dataclasses.dataclass(frozen=True)
class StochTables:
    """A compiled env's tables and stochastic mechanics in the layout of the
    stochastic kernels (B7, B8), with the per-lane step they share."""

    next: torch.Tensor             # [S, A] i32
    reward: torch.Tensor           # [S, A] f32
    hidden: torch.Tensor           # [S, A] f32
    done: torch.Tensor             # [S, A] u8
    cand0: Optional[torch.Tensor]  # [S, A] i32 carry candidate on coin 0 (mode 2)
    cand1: Optional[torch.Tensor]  # [S, A] i32 carry candidate on coin 1 (mode 2)
    drunk: Optional[torch.Tensor]  # [S] u8 drunk flag (whisky's noise)
    max_steps: int
    mode: int
    r0: int
    r1: int
    dry_nbits: int                 # K tomatoes whose bits dry (0: no drying)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.next.shape)

    @property
    def noise(self) -> bool:
        return self.drunk is not None

    def step(self, idx, t, epr, eph, epl, action, bits=None, stumble=None, rand_a=None):
        """One step of every lane, in the kernels' order: drying, the noisy
        action, the gathers, timeout, the reset select, accounting.

        ``idx`` is the index the agent observed (pre-dry). Returns the new
        ``(idx, t, ep_return, ep_hidden, ep_len)`` and ``(next_idx, reward,
        hidden, done, finished_return, finished_hidden, finished_len)``."""
        A = self.next.shape[1]
        e = idx
        if self.dry_nbits:
            e = e - (e & ((1 << self.dry_nbits) - 1) & bits)
        a = action
        if self.drunk is not None:
            a = torch.where((self.drunk[e.long()] != 0) & (stumble > 0), rand_a, a)
        k = e.long() * A + a.long()
        nxt = self.next.view(-1)[k]
        r = self.reward.view(-1)[k]
        h = self.hidden.view(-1)[k]
        t1 = t + 1
        done = (self.done.view(-1)[k] != 0) | (t1 >= self.max_steps)
        if self.mode == 1:
            reset = torch.where(bits > 0, torch.full_like(nxt, self.r1),
                                torch.full_like(nxt, self.r0))
        elif self.mode == 2:
            reset = torch.where(bits > 0, self.cand1.view(-1)[k], self.cand0.view(-1)[k])
        else:
            reset = torch.full_like(nxt, self.r0)
        epr1, eph1, epl1 = epr + r, eph + h, epl + 1
        new = (
            torch.where(done, reset, nxt),
            torch.where(done, torch.zeros_like(t1), t1),
            torch.where(done, torch.zeros_like(epr1), epr1),
            torch.where(done, torch.zeros_like(eph1), eph1),
            torch.where(done, torch.zeros_like(epl1), epl1),
        )
        return new, (nxt, r, h, done, epr1, eph1, epl1)


class VecEnv:
    """N lockstep instances of a compiled env.

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
        base = cenv.base
        self.noisy = cenv._noisy
        self.dry_nbits = int(base.n_tomatoes) if cenv._stochastic_index else 0

        if hasattr(base, "reset_from_coin"):
            r = base.state_index(base.reset_from_coin(
                torch.tensor([0, 1], dtype=torch.int32, device=self.device)))
            r0, r1 = (int(x) for x in r)
        else:
            r0 = r1 = int(base.state_index(base.reset(1, device=self.device))[0])
        cand = (None, None)
        if hasattr(base, "carry_reset_from_coin"):
            self.mode = 2
            self.carry_tab = self._carry_tables()
            cand = tuple(tab[cenv.next_table.long()].contiguous() for tab in self.carry_tab)
        else:
            self.mode = 1 if r0 != r1 else 0
        self.reset_idx_bit = (r0, r1)
        self.reset_idx = r0 if self.mode == 0 else None
        self.stochastic = bool(self.mode or self.noisy or self.dry_nbits)
        self.tables = StochTables(
            next=cenv.next_table.to(torch.int32).contiguous(),
            reward=cenv.reward_table.to(torch.float32).contiguous(),
            hidden=cenv.hidden_table.to(torch.float32).contiguous(),
            done=cenv.done_table.to(torch.uint8).contiguous(),
            cand0=cand[0], cand1=cand[1],
            drunk=cenv.state_store.drunk.to(torch.uint8).contiguous() if self.noisy else None,
            max_steps=self.max_steps, mode=self.mode, r0=r0, r1=r1,
            dry_nbits=self.dry_nbits,
        )

    def _carry_tables(self) -> torch.Tensor:
        """``[2, S]`` i32: the index ``carry_reset_from_coin`` gives each
        reachable state for coin 0 and coin 1 (unreachable rows stay 0)."""
        cenv = self.cenv
        reach = cenv.reachable.to(self.device)
        st = cenv.base_state(TableState(idx=reach, t=torch.zeros_like(reach)))
        tabs = torch.zeros((2, self.S), dtype=torch.int32, device=self.device)
        for b in (0, 1):
            coin = torch.full_like(reach, b)
            tabs[b, reach.long()] = cenv.base.state_index(
                cenv.base.carry_reset_from_coin(st, coin)).to(torch.int32)
        return tabs

    def reset_indices(self, generator=None) -> torch.Tensor:
        """``[N]`` i32 fresh-episode indices: a coin per lane in modes 1 and
        2 (coin 1 picks ``reset_idx_bit[1]``)."""
        n, dev = self.n_envs, self.device
        r0, r1 = self.reset_idx_bit
        if self.mode == 0:
            return torch.full((n,), r0, dtype=torch.int32, device=dev)
        if generator is None:
            raise ValueError(f"{self.cenv.name}: the reset draws a coin per lane; "
                             "pass a generator")
        coin = grid.coins(n, generator, dev)
        return torch.where(coin, torch.full((n,), r1, dtype=torch.int32, device=dev),
                           torch.full((n,), r0, dtype=torch.int32, device=dev))

    def reset(self, generator=None) -> VecState:
        n, dev = self.n_envs, self.device
        z_i = torch.zeros(n, dtype=torch.int32, device=dev)
        z_f = torch.zeros(n, dtype=torch.float32, device=dev)
        return VecState(idx=self.reset_indices(generator), t=z_i, ep_return=z_f,
                        ep_hidden=z_f.clone(), ep_len=z_i.clone())

    def draw_mechanics(self, generator, n_steps: int):
        """``(bits, stumble, rand_a)``, each ``[T, N]`` int32, drawn in that
        order: the reset coins (modes 1, 2) or tomato's dry coins packed
        little-endian, then whisky's stumble coins and random actions. A
        stream the env does not use is zeros and draws nothing."""
        shape, dev = (n_steps, self.n_envs), self.device
        zeros = torch.zeros(shape, dtype=torch.int32, device=dev)
        base = self.cenv.base
        if self.dry_nbits:
            dry = torch.rand(shape + (self.dry_nbits,), generator=generator,
                             device=dev) < base.dry_prob
            shifts = torch.arange(self.dry_nbits, dtype=torch.int32, device=dev)
            bits = (dry.to(torch.int32) << shifts).sum(-1, dtype=torch.int32)
        elif self.mode:
            bits = (torch.rand(shape, generator=generator, device=dev) < 0.5).to(torch.int32)
        else:
            bits = zeros
        if not self.noisy:
            return bits, zeros, zeros
        stumble = (torch.rand(shape, generator=generator, device=dev)
                   < base.stumble_prob).to(torch.int32)
        rand_a = torch.randint(0, self.A, shape, dtype=torch.int32, generator=generator,
                               device=dev)
        return bits, stumble, rand_a

    def step(self, state: VecState, actions: torch.Tensor, draws=None
             ) -> Tuple[VecState, Dict[str, torch.Tensor]]:
        """One step. ``draws`` is ``(bits, stumble, rand_a)``, each ``[N]``
        int32 (module doc); a stochastic env needs them."""
        if draws is None:
            if self.stochastic:
                raise ValueError(f"{self.cenv.name}: a stochastic step needs its draws")
            draws = (None, None, None)
        new, (nxt, r, h, done, epr, eph, epl) = self.tables.step(
            state.idx, state.t, state.ep_return, state.ep_hidden, state.ep_len,
            actions, *draws)
        out = dict(
            reward=r,
            hidden_reward=h,
            done=done,
            finished_return=epr,
            finished_hidden=eph,
            finished_len=epl,
            next_idx=nxt,
        )
        return VecState(*new), out

    def run_actions(self, state: VecState, actions_tn: torch.Tensor, draws=None
                    ) -> Tuple[VecState, Dict[str, torch.Tensor]]:
        """Step through a ``[T, N]`` action matrix (and ``[T, N]`` draws);
        returns stacked outs."""
        outs = []
        for s, row in enumerate(actions_tn):
            step_draws = None if draws is None else tuple(d[s] for d in draws)
            state, out = self.step(state, row, step_draws)
            outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def run_random_reduced(self, state: VecState, generator, n_steps: int,
                           actions: Optional[torch.Tensor] = None
                           ) -> Tuple[VecState, Dict[str, torch.Tensor]]:
        """The bench path of ``MXUVecEnv.run_random_reduced``: ONE ``[T, N]``
        int32 action draw up front (or the handed-over ``actions``), then, on
        a stochastic env, its mechanics from one ``draw_mechanics(generator,
        T)`` (the kernel engines' draw order), with the chunk totals
        ``reward_sum`` (f32), ``episodes`` (i32) and ``finished_return_sum``
        (f32) kept on the device."""
        dev = self.device
        if actions is None:
            actions = torch.randint(0, self.A, (n_steps, self.n_envs), dtype=torch.int32,
                                    generator=generator, device=dev)
        draws = self.draw_mechanics(generator, n_steps) if self.stochastic else None
        acc = {"reward_sum": torch.zeros((), dtype=torch.float32, device=dev),
               "episodes": torch.zeros((), dtype=torch.int32, device=dev),
               "finished_return_sum": torch.zeros((), dtype=torch.float32, device=dev)}
        for s in range(n_steps):
            state, out = self.step(state, actions[s],
                                   None if draws is None else tuple(d[s] for d in draws))
            done = out["done"]
            acc["reward_sum"] = acc["reward_sum"] + out["reward"].sum()
            acc["episodes"] = acc["episodes"] + done.sum(dtype=torch.int32)
            acc["finished_return_sum"] = acc["finished_return_sum"] + torch.where(
                done, out["finished_return"], torch.zeros_like(out["finished_return"])).sum()
        return state, acc
