"""Long-horizon cross-engine fuzz, bitwise: the counterpart of the repo's
``tools/fuzz.py``, with the same lines out.

    python -m safe_grid_agents_torch.tools.fuzz [--steps 2000] [--n-envs 512] [--seed 0] \\
        [--platform cpu]

For every alias of ``COMPILEABLE`` the array engine (``envs/array_vec.py``)
runs twice from the same lanes on the same actions and the same draws:
over the base env, and over the compiled env (``make_env(alias,
compiled=True)``: the friend family through its bounded substitute). Each
run's ``reward``, ``hidden_reward`` and ``done`` over ``steps × n_envs``
transitions must be bitwise equal; the first difference (the earliest
step, then lane, then field in that order) exits non-zero with ``MISMATCH
alias.field at (t, env)=...``.

The draws are made once and handed to both engines: the reset coins
(``[N]``, read by ``reset_from_coin``, or on the friend family by
``carry_reset_from_coin``) and the env's ``draw_step`` entries (whisky's
stumble and random action, tomato's dry coins). The base env reads them
through ``step_from_draws`` and its own coin resets, the compiled env
through its hooks in front of the table gathers and its coin resets as
indices, so one set of numbers drives both. On the friend family the run
is cut to ``4 · cap`` steps: a choice costs at least 4 steps, so the
carried imbalance stays inside the bounded substitute's cap, where the two
are equal. Actions and draws come from one ``torch.Generator`` on the run's
device (``cuda:0`` unless ``--platform cpu``, no fallback).
"""
from __future__ import annotations

import argparse

import torch

from ..device import platform_device
from ..envs import grid, make_env
from ..envs.array_vec import ArrayVecEnv

# The reference's compileable aliases (safe_grid_agents_tpu/envs/compiled.py),
# in its order: every alias compiles.
COMPILEABLE = [
    "shift", "shift-test", "island", "sokoban", "sokoban2", "boat", "tomato",
    "tomato-crmdp", "whisky", "absent", "interrupt", "conveyor", "conveyor-sushi",
    "friend", "foe", "neutral", "corners", "way", "toy",
]
FIELDS = ("reward", "hidden_reward", "done")


def compiled_env(alias: str, device):
    """The compiled side of the pair (a separate function so that a check
    can hand in altered tables)."""
    return make_env(alias, compiled=True, device=device)


def draws_of(vec: ArrayVecEnv, generator, device) -> dict | None:
    """One step's draws of a stochastic env: the reset coin, then the env's
    ``draw_step`` entries; ``None`` for a deterministic env."""
    if not vec.stochastic:
        return None
    n = vec.n_envs
    base = getattr(vec.env, "base", vec.env)
    d = {}
    if vec.coin_reset:
        d["coin"] = grid.coins(n, generator, device).to(torch.int32)
    if vec.step_draws:
        d.update(base.draw_step(n, generator, device))
    return d


def run_pair(alias: str, steps: int, n_envs: int, seed: int, device, comp=None):
    """Both engines over ``steps`` steps; returns the run's length and the
    first mismatch as ``(field, (t, env), base value, compiled value)``, or
    ``None``."""
    base = make_env(alias)
    comp = compiled_env(alias, device) if comp is None else comp
    if hasattr(comp.base, "cap"):
        steps = min(steps, 4 * comp.base.cap)
    vb, vc = ArrayVecEnv(base, n_envs, device), ArrayVecEnv(comp, n_envs)
    g = torch.Generator(device=device).manual_seed(seed)
    coin = grid.coins(n_envs, g, device).to(torch.int32) if vb.coin_reset else None
    sb, sc = vb.reset(coin=coin), vc.reset(coin=coin)
    actions = torch.randint(0, base.n_actions, (steps, n_envs), dtype=torch.int32,
                            generator=g, device=device)
    outs = {f: ([], []) for f in FIELDS}
    for t in range(steps):
        d = draws_of(vb, g, device)
        sb, ob = vb.step(sb, actions[t], d)
        sc, oc = vc.step(sc, actions[t], d)
        for f in FIELDS:
            outs[f][0].append(ob[f])
            outs[f][1].append(oc[f])
    pairs = {f: (torch.stack(outs[f][0]), torch.stack(outs[f][1])) for f in FIELDS}
    differ = torch.stack([a != b for a, b in pairs.values()])   # [field, T, N]
    if not differ.any():
        return steps, None
    # The first transition (t, then env) where any field differs, and the
    # first of the fields that differs there.
    bad = tuple(int(i) for i in differ.any(0).nonzero()[0])
    f = FIELDS[int(differ[(slice(None),) + bad].int().argmax())]
    a, b = pairs[f]
    return steps, (f, bad, a[bad].item(), b[bad].item())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--n-envs", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", type=str, default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = platform_device(args.platform)
    total = 0
    for alias in COMPILEABLE:
        steps, bad = run_pair(alias, args.steps, args.n_envs, args.seed, device)
        if bad is not None:
            field, at, vb, vc = bad
            raise SystemExit(f"MISMATCH {alias}.{field} at (t, env)={at}: "
                             f"base {vb} compiled {vc}")
        total += steps * args.n_envs
        print(f"{alias:16s} OK  ({steps * args.n_envs:,} transitions)", flush=True)
    print(f"all {len(COMPILEABLE)} aliases bitwise-identical over {total:,} transitions")
    return total


if __name__ == "__main__":
    main()
