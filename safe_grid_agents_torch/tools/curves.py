"""Learning-curve capture and regression goldens: the counterpart of the
repo's ``tools/curves.py``, with its three configs.

    python -m safe_grid_agents_torch.tools.curves --update --platform cpu
        # regenerate safe_grid_agents_torch/tools/goldens/curves.json
    python -m safe_grid_agents_torch.tools.curves [--seeds 0] [--check] [--platform cpu]
        # print current curves (--check: hold each to the reference's band)

Each config trains a base trainer (``make_agent`` + ``make_trainer`` over
the array engine) for ``n_chunks`` chunks and records a greedy eval from
fresh lanes every ``eval_every`` chunks; a DQN config first fills its ring
with a random-policy warmup. An eval that ends no episode fails loudly. The
goldens hold seeds 0, 1 and 2 and come from the CPU; ``--check`` holds
each seed's best return and final hidden to the seed band of the
reference's ``tests/goldens/curves.json`` ± ``TOL`` (as
``tests/test_curves.py`` does), which is how a card run is checked.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..agents import make_agent
from ..device import platform_device
from ..envs import make_env
from ..envs.array_vec import ArrayVecEnv
from ..training import make_trainer, stats_to_host

GOLDEN_PATH = Path(__file__).resolve().parent / "goldens" / "curves.json"
REFERENCE_GOLDEN_PATH = Path(__file__).resolve().parents[2] / "tests" / "goldens" / "curves.json"
TOL = 5.0
SEEDS = (0, 1, 2)

# (name, env, agent, agent_kwargs, n_envs, chunk_steps, n_chunks, eval_every,
#  eval_steps, warmup), as the reference's tools/curves.py:29-72.
CONFIGS = [
    dict(
        name="tabq_shift",
        env="shift",
        agent="tabular-q",
        agent_kwargs={"lr": 0.2, "epsilon_anneal_steps": 20_000},
        n_envs=64,
        chunk_steps=128,
        n_chunks=12,
        eval_every=3,
        eval_steps=30,
    ),
    dict(
        name="dqn_sokoban",
        env="sokoban",
        agent="deep-q",
        agent_kwargs={
            "lr": 5e-4,
            "epsilon_anneal_steps": 60_000,
            "batch_size": 128,
            "replay_capacity": 50_000,
            "sync_every": 100,
        },
        n_envs=128,
        chunk_steps=32,
        n_chunks=20,
        eval_every=4,
        eval_steps=120,
        warmup=40,
    ),
    dict(
        name="ppo_corners",
        env="corners",
        agent="ppo-mlp",
        agent_kwargs={"lr": 1e-3, "entropy_bonus": 0.05},
        n_envs=64,
        chunk_steps=16,
        n_chunks=60,
        eval_every=15,
        eval_steps=25,
    ),
]


def collect_curve(cfg: dict, seed: int, device="cpu") -> list:
    """The config's eval curve at ``seed``: ``[{"return", "hidden"}, ...]``."""
    env = make_env(cfg["env"])
    vec = ArrayVecEnv(env, cfg["n_envs"], device)
    agent = make_agent(cfg["agent"], env, **cfg.get("agent_kwargs", {}))
    trainer = make_trainer(cfg["agent"], agent, vec)
    g = torch.Generator(device=vec.device).manual_seed(seed)
    astate, vstate = trainer.init(seed=seed, generator=g)
    if cfg.get("warmup"):
        astate, vstate, _ = trainer.warmup_chunk(astate, vstate, g, cfg["warmup"])
    curve = []
    for i in range(cfg["n_chunks"]):
        out = trainer.train_chunk(astate, vstate, g, cfg["chunk_steps"])
        astate, vstate = out[0], out[1]
        if (i + 1) % cfg["eval_every"] == 0:
            with torch.no_grad():
                _, es = trainer.eval_chunk(astate, vec.reset(g), cfg["eval_steps"],
                                           generator=g)
            s = stats_to_host(es)
            # A zero-episode eval reports NaN means; a golden curve must never
            # bake NaN in, so collection fails loudly instead.
            assert s["episodes"] > 0, (
                f"{cfg['name']} seed {seed}: no eval episodes finished at "
                f"chunk {i + 1} — raise eval_steps for this config"
            )
            curve.append({"return": round(s["mean_return"], 3),
                          "hidden": round(s["mean_hidden"], 3)})
    return curve


def band_check(name: str, curve: list, stored: dict, tol: float = TOL) -> dict:
    """``tests/test_curves.py``'s check of one curve against a stored seed
    band: the best eval return and the final hidden each within the band's
    range ± ``tol``. Returns the numbers and ``ok``."""
    best_band = [max(p["return"] for p in c) for c in stored[name].values()]
    hidden_band = [c[-1]["hidden"] for c in stored[name].values()]
    best = max(p["return"] for p in curve)
    final_hidden = curve[-1]["hidden"]
    ok = (min(best_band) - tol <= best <= max(best_band) + tol
          and min(hidden_band) - tol <= final_hidden <= max(hidden_band) + tol)
    return {"best": best, "best_band": best_band, "final_hidden": final_hidden,
            "hidden_band": hidden_band, "ok": ok}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true", help="rewrite the goldens (CPU only)")
    ap.add_argument("--check", action="store_true",
                    help="hold each curve to the reference's seed band ± TOL; exit non-zero "
                         "if one is outside it")
    ap.add_argument("--seeds", type=str, default=None, help="comma-separated (default 0,1,2)")
    ap.add_argument("--platform", type=str, default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = platform_device(args.platform)
    if args.update and (device.type != "cpu" or args.seeds):
        raise SystemExit("--update writes the CPU goldens at seeds 0, 1, 2: add --platform "
                         "cpu, drop --seeds")
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else list(SEEDS)
    reference = json.loads(REFERENCE_GOLDEN_PATH.read_text()) if args.check else None
    out, failed = {}, []
    for cfg in CONFIGS:
        out[cfg["name"]] = {str(seed): collect_curve(cfg, seed, device) for seed in seeds}
        print(cfg["name"], json.dumps(out[cfg["name"]][str(seeds[0])]), flush=True)
        if reference is not None:
            for seed in seeds:
                c = band_check(cfg["name"], out[cfg["name"]][str(seed)], reference)
                print(f"  seed {seed} against the reference's band ± {TOL}: {json.dumps(c)}",
                      flush=True)
                if not c["ok"]:
                    failed.append((cfg["name"], seed))
    if args.update:
        GOLDEN_PATH.parent.mkdir(parents=True, exist_ok=True)
        with open(GOLDEN_PATH, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {GOLDEN_PATH}")
    if failed:
        raise SystemExit(f"outside the reference's seed band: {failed}")
    return out


if __name__ == "__main__":
    main()
