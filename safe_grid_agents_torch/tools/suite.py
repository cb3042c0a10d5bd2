"""All-env training suite over the port's CLI: the counterpart of the
repo's ``tools/suite.py``, with the same rows and table.

    python -m safe_grid_agents_torch.tools.suite ppo-mlp --steps 200000 --n-envs 256 \\
        [--n-devices 8] [--envs shift,island] [--platform cpu] [--extra FLAGS...]

Runs the agent on every compatible alias (tabular agents need a finite
state index), one ``cli.main.run`` each in this process, and prints one
JSON row per alias (NaN as ``null``) and then the table of final observed
return against hidden performance. ``--platform`` is passed to every run
(``cuda:0`` unless ``cpu``, no fallback).
"""
from __future__ import annotations

import argparse
import json

from ..cli.main import run
from ..device import platform_device
from ..envs import ALL_ENV_ALIASES, make_env
from .sweep import rounded


def compatible(alias: str, agent: str) -> bool:
    if agent in ("tabular-q", "ppo-crmdp"):
        return make_env(alias).num_states is not None
    return True


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("agent")
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--n-envs", type=int, default=128)
    ap.add_argument("--n-devices", type=int, default=1)
    ap.add_argument("--chunk-steps", type=int, default=64)
    ap.add_argument("--envs", type=str, default=None,
                    help="comma-separated aliases (default: all)")
    ap.add_argument("--platform", type=str, default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="extra CLI flags passed through to every run")
    args = ap.parse_args(argv)
    platform_device(args.platform)
    platform = [] if args.platform is None else ["--platform", args.platform]

    aliases = args.envs.split(",") if args.envs else ALL_ENV_ALIASES
    rows = []
    for alias in aliases:
        if not compatible(alias, args.agent):
            print(f"-- {alias}: skipped (no tabular state index)", flush=True)
            continue
        stats = run(
            [
                alias, args.agent,
                "--steps", str(args.steps),
                "--n-envs", str(args.n_envs),
                "--n-devices", str(args.n_devices),
                "--chunk-steps", str(args.chunk_steps),
                "--eval-every", "1000000",
            ]
            + platform + args.extra
        )
        rows.append({"env": alias, **rounded(stats, 2)})
        print(json.dumps(rows[-1]), flush=True)

    print(f"\n{'env':16s} {'return':>10s} {'hidden':>10s} {'episodes':>9s}")
    for r in rows:
        def _f(key, missing=float("nan")):
            v = r.get(key)
            return missing if v is None else v

        print(
            f"{r['env']:16s} {_f('mean_return'):10.2f} "
            f"{_f('mean_hidden'):10.2f} {_f('episodes', 0):9.0f}"
        )
    return rows


if __name__ == "__main__":
    main()
