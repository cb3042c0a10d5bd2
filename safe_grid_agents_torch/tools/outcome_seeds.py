"""Final greedy evals of this slice's CLI commands over seeds: the tabular
suite's rows (RESULTS.md:3-5, :17, :23-27) and the MXU goldens' budget for
boat, conveyor deep-q at the Deep-Q suite's recipe, boat's PPO preset,
corners ppo-crmdp on the MXU and fused trainers at the reference's CLI gate
(tests/test_cli.py:382-412) and the tomato-crmdp preset; and, on the array
engine (``array ...``), the suite recipe on friend, foe and neutral, and
the reference's agent gates through the CLI's base trainers: PPO camping
corners (tests/test_agents.py:119), base CRMDP on corners (:132; with
``--eval-every`` past the last chunk the final eval is the gate's last
one) and base DQN on sokoban (:86, final eval); and ``shift ppo-cnn
--preset --compiled --mxu`` (``tools/agent_gates.py``'s gate, the
reference's claim 40/40 on seeds 0-2). ``chip_smoke.py`` and
``tools/agent_gates.py`` pin or sweep the seeds they gate from these runs. On the card (or with
``--platform cpu`` for a CPU run):

    python -m safe_grid_agents_torch.tools.outcome_seeds [--only PREFIX ...] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from ..cli.main import run

CRMDP = ["--n-envs", "32", "--steps", "40000", "--chunk-steps", "16", "--eval-every", "20",
         "--eval-steps", "25", "--lr", "0.001", "--entropy-bonus", "0.05", "--crmdp-lr", "1.0"]
TAB = ["tabular-q", "--compiled", "--mxu", "--fused-kernel", "--steps", "2000000",
       "--chunk-steps", "128", "--lr", "0.2", "--epsilon-anneal-steps", "600000",
       "--epsilon-final", "0.03"]
FUSED_PPO = ["--compiled", "--mxu", "--table-net", "--fused-kernel"]
ARRAY_TAB = ["tabular-q", "--n-envs", "256", "--steps", "2000000", "--chunk-steps", "128",
             "--lr", "0.2", "--epsilon-anneal-steps", "600000", "--epsilon-final", "0.03"]
ARRAY_CORNERS = ["--n-envs", "64", "--chunk-steps", "16", "--eval-every", "1000",
                 "--eval-steps", "25", "--lr", "0.001", "--entropy-bonus", "0.05"]


def commands() -> dict:
    """``name -> argv`` of every run of the sweep."""
    out = {}
    for alias in ("toy", "corners", "way", "boat", "conveyor", "conveyor-sushi"):
        out[f"tab {alias}"] = [alias] + TAB + ["--n-envs",
                                               "128" if alias.startswith("conveyor") else "256"]
    out["tab boat golden"] = ["boat", "tabular-q", "--compiled", "--mxu", "--fused-kernel",
                              "--n-envs", "64", "--steps", "49152", "--chunk-steps", "128",
                              "--lr", "0.2", "--epsilon-anneal-steps", "20000",
                              "--epsilon-final", "0.03", "--eval-steps", "150"]
    out["conveyor deep-q"] = ["conveyor", "deep-q", "--compiled", "--mxu", "--fused-kernel",
                              "--steps", "500000", "--n-envs", "128", "--chunk-steps", "32",
                              "--lr", "0.0005", "--epsilon-anneal-steps", "150000",
                              "--batch-size", "128", "--sync-every", "100", "--replay-capacity",
                              "50000", "--warmup-steps", "32"]
    for s in range(4):
        out[f"boat ppo s{s}"] = ["boat", "ppo-mlp", "--preset"] + FUSED_PPO + ["--seed", str(s)]
    for s in range(8):
        out[f"corners crmdp mxu s{s}"] = (["corners", "ppo-crmdp", "--compiled", "--mxu"]
                                          + CRMDP + ["--seed", str(s)])
        out[f"corners crmdp fused s{s}"] = (["corners", "ppo-crmdp"] + FUSED_PPO + CRMDP
                                            + ["--seed", str(s)])
    for s in range(6):
        out[f"tomato-crmdp s{s}"] = (["tomato-crmdp", "ppo-crmdp", "--preset"] + FUSED_PPO
                                     + ["--seed", str(s)])
    for alias, n_seeds in (("friend", 3), ("foe", 4), ("neutral", 6)):
        for s in range(n_seeds):
            out[f"array {alias} s{s}"] = [alias] + ARRAY_TAB + ["--seed", str(s)]
    for s in range(12):
        out[f"array crmdp s{s}"] = ["corners", "ppo-crmdp"] + ARRAY_CORNERS + [
            "--steps", str(80 * 16 * 64), "--crmdp-lr", "1.0", "--seed", str(s)]
    for s in range(4):
        out[f"array ppo s{s}"] = ["corners", "ppo-mlp"] + ARRAY_CORNERS + [
            "--steps", str(60 * 16 * 64), "--seed", str(s)]
    for s in range(3):
        out[f"array dqn s{s}"] = ["sokoban", "deep-q", "--n-envs", "128", "--chunk-steps", "32",
                                  "--steps", str(15 * 32 * 128), "--lr", "0.0005",
                                  "--epsilon-anneal-steps", "60000", "--batch-size", "128",
                                  "--replay-capacity", "50000", "--sync-every", "100",
                                  "--updates-per-chunk", "32", "--warmup-steps", "40",
                                  "--eval-steps", "60", "--seed", str(s)]
    for s in range(8):
        out[f"shift ppo-cnn s{s}"] = ["shift", "ppo-cnn", "--preset", "--compiled", "--mxu",
                                      "--seed", str(s)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", nargs="*", default=[], help="run names starting with these")
    p.add_argument("--platform", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    extra = ["--platform", args.platform] if args.platform else []
    result = {}
    for name, cmd in commands().items():
        if args.only and not any(name.startswith(o) for o in args.only):
            continue
        t0 = time.perf_counter()
        stats = run(cmd + extra)
        result[name] = dict(stats, wall_s=time.perf_counter() - t0)
        print(f"{name}: observed {stats['mean_return']}, hidden {stats['mean_hidden']} "
              f"({result[name]['wall_s']:.2f} s)", flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
