"""Compiled tabular engine: whole environments as lookup tables.

Counterpart of ``safe_grid_agents_tpu/envs/compiled.py``. The reachable state
graph of an enumerable, deterministic env is walked ONCE by breadth-first
search and baked into dense tables

    next_idx [S, A] i32   reward [S, A] f32   hidden [S, A] f32
    done     [S, A] bool  obs    [S, P, H, W] f32   board [S, H, W] i8

after which a batched step is a few gathers and a timeout compare. The
search always runs on the CPU (its frontiers are small and many-shaped);
the finished tables then move to the run's device once.

Parity is by construction: tables are filled by calling the base env's own
``step`` (or ``deterministic_step`` where the base has one), with the same
determinism probe and timeout stripping as the JAX build. Per-step
randomness compiles through two hooks that run in front of the table
gathers on the step's draws: ``noisy_action`` (whisky's drunk stumble, on
the ``stumble``/``rand_action`` draws) and ``stochastic_index`` (tomato's
drying applied to the watered bits of the index, on the ``dry`` draw).
``enumerate_states`` seeds the build where drying reaches states that a
search from the resets never would. The BFS starts from both coin resets
where the base has ``reset_from_coin``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ..device import resolve_device
from ..types import StepOut, map_fields
from .base import Env

_CPU = torch.device("cpu")


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _same(x: Any, y: Any) -> bool:
    """Field-by-field bitwise equality of tensors, dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        return bool(torch.equal(x, y))
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    return all(
        _same(getattr(x, f.name), getattr(y, f.name))
        for f in dataclasses.fields(x)
    )


@dataclasses.dataclass
class TableState:
    idx: torch.Tensor  # [N] i32 — state index into the tables
    t: torch.Tensor    # [N] i32 — episode step count (timeout only)


class CompiledEnv(Env):
    """Lookup-table execution of an enumerable base env."""

    def __init__(self, base: Env, device=None):
        if base.num_states is None:
            raise ValueError(f"{base.name}: not enumerable")
        self.base = base
        self.name = f"{base.name}+compiled"
        self.n_actions = base.n_actions
        self.height, self.width = base.height, base.width
        self.n_planes = base.n_planes
        self.max_steps = base.max_steps
        self.num_states = base.num_states
        self.device = resolve_device(device)
        self._noisy = hasattr(base, "noisy_action")
        self._stochastic_index = hasattr(base, "stochastic_index")
        self._build_tables()
        for name in ("next_table", "reward_table", "hidden_table",
                     "done_table", "reachable", "obs_table", "board_table"):
            setattr(self, name, getattr(self, name).to(self.device))
        self.info_tables = {
            k: v.to(self.device) for k, v in self.info_tables.items()
        }
        self.state_store = map_fields(lambda x: x.to(self.device), self.state_store)

    # -- build (CPU) -------------------------------------------------------
    def _build_tables(self):
        base, S, A = self.base, self.num_states, self.n_actions
        step_gen = _gen(0)
        if hasattr(base, "deterministic_step"):
            step_fn = base.deterministic_step
        else:
            # Determinism check: stepping under many different generators
            # must agree bitwise (a single alternate seed could match by
            # chance).
            s0 = base.reset(1, _gen(3), device=_CPU)
            a0 = torch.zeros(1, dtype=torch.int32)
            ref = base.step(s0, a0, _gen(100))
            for probe in range(101, 133):
                if not _same(ref, base.step(s0, a0, _gen(probe))):
                    raise ValueError(
                        f"{base.name}: step consumes randomness — not compileable"
                    )
            step_fn = lambda s, a: base.step(s, a, step_gen)  # noqa: E731

        # Reset-state support: both coin resets where the reset draws one,
        # then every state the env enumerates for its stochastic hooks.
        if hasattr(base, "reset_from_coin"):
            starts = [base.reset_from_coin(torch.tensor([c], dtype=torch.int32))
                      for c in (0, 1)]
        else:
            starts = [base.reset(1, _gen(3), device=_CPU)]
        if hasattr(base, "enumerate_states"):
            batch = base.enumerate_states()
            starts += [map_fields(lambda x: x[j:j + 1].clone(), batch)
                       for j in range(base.state_index(batch).shape[0])]
        seen: Dict[int, Any] = {}
        for st in starts:
            seen.setdefault(int(base.state_index(st)[0]), st)

        # BFS over the reachable graph, one batched step per frontier/action.
        store: Dict[int, Any] = dict(seen)
        frontier: List[int] = list(seen)
        visited = set(frontier)
        nxt = np.zeros((S, A), np.int32)
        rew = np.zeros((S, A), np.float32)
        hid = np.zeros((S, A), np.float32)
        done = np.zeros((S, A), bool)
        infos: Dict[str, np.ndarray] = {}
        while frontier:
            n = len(frontier)
            states = map_fields(lambda *xs: torch.cat(xs), *[store[i] for i in frontier])
            fr = np.asarray(frontier)
            new_frontier: List[int] = []
            for a in range(A):
                out = step_fn(states, torch.full((n,), a, dtype=torch.int32))
                idxs = base.state_index(out.state).numpy()
                nxt[fr, a] = idxs
                rew[fr, a] = out.reward.numpy()
                hid[fr, a] = out.hidden_reward.numpy()
                # Strip the timeout component: BFS states carry t=0, so the
                # base env's done here is the pure env-terminal signal.
                done[fr, a] = out.done.numpy() & (out.state.t.numpy() < self.max_steps)
                for k, v in out.info.items():
                    v = v.numpy()
                    infos.setdefault(k, np.zeros((S, A), v.dtype))[fr, a] = v
                # Expand ALL successors, post-terminal ones included, stored
                # with t reset to 0 (state_index ignores t).
                for j, i_new in enumerate(idxs.tolist()):
                    if i_new not in visited:
                        visited.add(i_new)
                        new_frontier.append(i_new)
                        st = map_fields(lambda x: x[j:j + 1].clone(), out.state)
                        store[i_new] = dataclasses.replace(
                            st, t=torch.zeros(1, dtype=torch.int32)
                        )
            frontier = new_frontier

        self.next_table = torch.from_numpy(nxt)
        self.reward_table = torch.from_numpy(rew)
        self.hidden_table = torch.from_numpy(hid)
        self.done_table = torch.from_numpy(done)
        self.info_tables = {k: torch.from_numpy(v) for k, v in infos.items()}
        reach = sorted(visited)
        self.reachable = torch.tensor(reach, dtype=torch.int32)

        # Dense render tables and state store over the reachable set,
        # scattered into index space (unreachable rows stay zero).
        reach_states = map_fields(lambda *xs: torch.cat(xs), *[store[i] for i in reach])
        rows = self.reachable.long()
        obs_r = base.observe(reach_states)
        board_r = base.board(reach_states)
        self.obs_table = torch.zeros((S,) + tuple(obs_r.shape[1:]), dtype=torch.float32)
        self.obs_table[rows] = obs_r
        self.board_table = torch.zeros((S,) + tuple(board_r.shape[1:]), dtype=torch.int8)
        self.board_table[rows] = board_r

        def dense(leaf):
            out = torch.zeros((S,) + tuple(leaf.shape[1:]), dtype=leaf.dtype)
            out[rows] = leaf
            return out

        self.state_store = map_fields(dense, reach_states)

    # -- runtime -----------------------------------------------------------
    def base_state(self, state: TableState):
        """Reconstruct the base env's batched State (t from the counter)."""
        full = map_fields(lambda tab: tab[state.idx.long()], self.state_store)
        return dataclasses.replace(full, t=state.t)

    def reset(self, n: int, generator=None, device=None) -> TableState:
        dev = self.device if device is None else device
        st = self.base.reset(n, generator, device=dev)
        return TableState(
            idx=self.base.state_index(st).to(torch.int32),
            t=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def carry_reset(self, state: TableState, generator=None) -> TableState:
        st = self.base.carry_reset(self.base_state(state), generator)
        return TableState(
            idx=self.base.state_index(st).to(torch.int32),
            t=torch.zeros_like(state.t),
        )

    def reset_from_coin(self, coin: torch.Tensor) -> TableState:
        """The base env's coin reset (absent, interrupt, the friend family),
        as indices."""
        st = self.base.reset_from_coin(coin)
        return TableState(idx=self.base.state_index(st).to(torch.int32),
                          t=torch.zeros(coin.shape[0], dtype=torch.int32, device=coin.device))

    def carry_reset_from_coin(self, state: TableState, coin: torch.Tensor) -> TableState:
        """The base env's carried reset (the friend family), as indices."""
        st = self.base.carry_reset_from_coin(self.base_state(state), coin)
        return TableState(idx=self.base.state_index(st).to(torch.int32),
                          t=torch.zeros_like(state.t))

    def step(self, state: TableState, action, generator=None, draws=None) -> StepOut:
        """One table step. Envs with per-step randomness take the base
        env's draws (``draw_step``'s dict: whisky ``stumble`` and
        ``rand_action``, tomato ``dry``), drawn from ``generator`` when not
        given; the hooks apply them in front of the gathers."""
        if (self._noisy or self._stochastic_index) and draws is None:
            draws = self.base.draw_step(state.idx.shape[0], generator, state.idx.device)
        if self._noisy:
            action = self.base.noisy_action(self.base_state(state), action, **draws)
        i, a = state.idx, action.long()
        if self._stochastic_index:
            i = self.base.stochastic_index(i, self.base.dry_mask(draws["dry"]))
        i = i.long()
        t = state.t + 1
        return StepOut(
            state=TableState(idx=self.next_table[i, a], t=t),
            reward=self.reward_table[i, a],
            hidden_reward=self.hidden_table[i, a],
            done=self.done_table[i, a] | self._timeout(t),
            info={k: v[i, a] for k, v in self.info_tables.items()},
        )

    def observe(self, state: TableState) -> torch.Tensor:
        return self.obs_table[state.idx.long()]

    def board(self, state: TableState) -> torch.Tensor:
        return self.board_table[state.idx.long()]

    def state_index(self, state: TableState) -> torch.Tensor:
        return state.idx


def compile_env(base: Env, device=None) -> CompiledEnv:
    return CompiledEnv(base, device)
