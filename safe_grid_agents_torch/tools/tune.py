"""ASHA-style successive-halving tuner over the port's CLI: the counterpart
of the repo's ``tools/tune.py``, with the same arguments, sampling and
lines out.

Random-samples N configs, trains every config for a rung budget, keeps the
top 1/eta by eval mean_return, and resumes the survivors from their own
checkpoints (the CLI's ``--checkpoint-dir``/``--resume``) for the next,
eta× longer rung, so a promotion costs only the added steps.

    python -m safe_grid_agents_torch.tools.tune island ppo-mlp --samples 8 --rungs 3 \\
        --eta 2 --rung-steps 20000 --space lr=1e-4,3e-4,1e-3 --space clipping=0.1,0.2 \\
        [--platform cpu] [base CLI flags...]

``--space flag=v1,v2,...`` is a categorical dimension (values drawn
uniformly); ``--space flag=log:lo:hi`` a log-uniform float. The configs are
drawn with Python's ``random.Random(--tune-seed)`` in the reference's
order, so both tools sample the same configs for the same seed and space.
Results stream as JSONL; the last line is the winner. ``--platform`` goes
through to every run (``cuda:0`` unless ``cpu``, no fallback).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import random
import shutil
import sys
import tempfile

from ..cli.main import run
from ..device import platform_device, platform_in


def parse_space(specs):
    """[('lr', 'log:1e-4:1e-2'), ...] → {name: sampler(rng)}"""
    space = {}
    for name, _, spec in (s.partition("=") for s in specs):
        if spec.startswith("log:"):
            _, lo, hi = spec.split(":")
            lo, hi = float(lo), float(hi)
            space[name] = lambda rng, lo=lo, hi=hi: float(
                math.exp(rng.uniform(math.log(lo), math.log(hi)))
            )
        else:
            vals = spec.split(",")
            space[name] = lambda rng, vals=vals: rng.choice(vals)
    return space


def sample_configs(specs, samples: int, seed: int) -> list:
    """The ``samples`` configs drawn from ``specs`` by ``random.Random(seed)``."""
    rng = random.Random(seed)
    space = parse_space(specs)
    return [{name: sample(rng) for name, sample in space.items()} for _ in range(samples)]


def _score(stats: dict) -> float:
    score = stats.get("mean_return", float("-inf"))
    return float("-inf") if score != score else score  # NaN (no eval episode): worst


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("env")
    ap.add_argument("agent")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--rungs", type=int, default=3)
    ap.add_argument("--eta", type=int, default=2, help="keep top 1/eta per rung")
    ap.add_argument("--rung-steps", type=int, default=20_000,
                    help="env steps of the first rung (each rung is eta× longer)")
    ap.add_argument("--space", action="append", default=[],
                    help="flag=v1,v2,... or flag=log:lo:hi")
    ap.add_argument("--tune-seed", type=int, default=0)
    ap.add_argument("--final-gate", type=int, default=0, metavar="K",
                    help="after the rung loop, resume the top-K configs by their "
                         "latest score to --final-steps and pick the winner by that "
                         "eval (rung returns favor peaks before a collapse)")
    ap.add_argument("--final-steps", type=int, default=None,
                    help="budget for the --final-gate runs (default: one "
                         "eta-rung beyond the last rung)")
    ap.add_argument("--work-dir", type=str, default=None,
                    help="checkpoint root (default: temp dir, cleaned up)")
    args, passthrough = ap.parse_known_args(argv)
    if not args.space:
        ap.error("need at least one --space dimension")
    platform_device(platform_in(passthrough))

    configs = sample_configs(args.space, args.samples, args.tune_seed)

    def train(i: int, steps: int) -> dict:
        extra = []
        for name, val in configs[i].items():
            extra += [f"--{name}", str(val)]
        return run([args.env, args.agent, "--steps", str(steps),
                    "--checkpoint-dir", os.path.join(work, f"cfg{i}"), "--resume"]
                   + passthrough + extra)

    def line(rung, steps: int, i: int, stats: dict) -> None:
        print(json.dumps({"rung": rung, "steps": steps, "cfg": i, **configs[i],
                          **{k: round(v, 3) for k, v in stats.items()}}), flush=True)

    work = args.work_dir or tempfile.mkdtemp(prefix="sga_tune_")
    cleanup = args.work_dir is None
    try:
        alive = list(range(len(configs)))
        latest = {}  # cfg index → most recent rung score
        for rung in range(args.rungs):
            steps = args.rung_steps * (args.eta ** rung)
            scores = []
            for i in alive:
                stats = train(i, steps)
                scores.append((_score(stats), i))
                latest[i] = scores[-1][0]
                line(rung, steps, i, stats)
            # Promote the top 1/eta (ties broken by config index); a single
            # survivor finishes its budget in the remaining rungs.
            scores.sort(key=lambda t: (-t[0], t[1]))
            keep = max(1, len(alive) // args.eta)
            alive = [i for _, i in scores[:keep]]
        if args.final_gate:
            # The top-K by latest score, rung losers included (a config
            # killed at a short horizon can win at the real budget), each
            # resumed to the final budget and scored by the eval there.
            pool = sorted(latest.items(), key=lambda kv: (-kv[1], kv[0]))
            finalists = [i for i, _ in pool[: args.final_gate]]
            final_steps = args.final_steps or (args.rung_steps * (args.eta ** args.rungs))
            fscores = []
            for i in finalists:
                stats = train(i, final_steps)
                fscores.append((_score(stats), i))
                line("final", final_steps, i, stats)
            fscores.sort(key=lambda t: (-t[0], t[1]))
            best = fscores[0][1]
        else:
            best = alive[0]
        print(json.dumps({"winner": best, **configs[best]}), flush=True)
        return configs[best]
    finally:
        if cleanup:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
