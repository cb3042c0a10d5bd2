"""The compiled-engine tabular suite pinned to goldens: the counterpart of
the repo's ``tools/mxu_goldens.py``.

    python -m safe_grid_agents_torch.tools.mxu_goldens --update --platform cpu
        # regenerate safe_grid_agents_torch/tools/goldens/mxu_suite.json
    python -m safe_grid_agents_torch.tools.mxu_goldens [--platform cpu]
        # print current vs goldens

A short deterministic run per alias of ``MXUTabularQTrainer`` over the
compiled engine (``envs/vec.py::VecEnv``), at the reference's budget and
agent: ``N_ENVS`` lanes, ``N_CHUNKS`` chunks of ``CHUNK`` steps from
seed 0, lr 0.2, ε annealed over 20,000 steps to 0.03, then a greedy eval
of ``EVAL_STEPS`` steps from fresh lanes. friend/foe/neutral are left out
(index-keyed tabular Q reads their hidden box), sokoban2 on cost, as in
the reference. Goldens come from the CPU (``--update`` requires
``--platform cpu``); ``tests/test_torch_mxu_goldens.py`` holds each
alias's (return, hidden) to them and to the reference's
``tests/goldens/mxu_suite.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..agents.tabular import TabularQAgent
from ..device import platform_device
from ..envs import make_env
from ..envs.vec import VecEnv
from ..training import MXUTabularQTrainer, stats_to_host

GOLDEN_PATH = Path(__file__).resolve().parent / "goldens" / "mxu_suite.json"

ALIASES = [
    "shift", "shift-test", "island", "sokoban", "boat", "tomato",
    "tomato-crmdp", "whisky", "absent", "interrupt", "conveyor",
    "conveyor-sushi", "corners", "way", "toy",
]

N_ENVS = 64
CHUNK = 128
N_CHUNKS = 6          # 49,152 env steps — deterministic short budget
EVAL_STEPS = 150


def run_alias(alias: str, seed: int = 0, device="cpu"):
    """The short MXU-tabular run of ``alias``; returns its final greedy eval."""
    cenv = make_env(alias, compiled=True, device=device)
    agent = TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000, epsilon_final=0.03)
    tr = MXUTabularQTrainer(agent, VecEnv(cenv, N_ENVS))
    g = torch.Generator(device=cenv.device).manual_seed(seed)
    astate, vstate = tr.init(g)
    with torch.no_grad():
        for _ in range(N_CHUNKS):
            astate, vstate, _ = tr.train_chunk(astate, vstate, g, CHUNK)
        _, es = tr.eval_chunk(astate, tr.vec.reset(g), EVAL_STEPS, generator=g)
    s = stats_to_host(es)
    return {"return": round(s["mean_return"], 3), "hidden": round(s["mean_hidden"], 3)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true", help="rewrite the goldens (CPU only)")
    ap.add_argument("--platform", type=str, default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = platform_device(args.platform)
    if args.update and device.type != "cpu":
        raise SystemExit("--update writes the CPU goldens: add --platform cpu")
    results = {}
    for alias in ALIASES:
        results[alias] = run_alias(alias, device=device)
        print(alias, results[alias], flush=True)
    if args.update:
        with open(GOLDEN_PATH, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
        print(f"wrote {GOLDEN_PATH}")
    else:
        stored = json.loads(GOLDEN_PATH.read_text())
        for alias, got in results.items():
            print(alias, "golden", stored.get(alias), "current", got)
    return results


if __name__ == "__main__":
    main()
