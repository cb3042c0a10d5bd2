"""Where a step of the array engine goes on one card.

    python -m safe_grid_agents_torch.tools.trace_array [--lanes 4096] [--out FILE]

The array engine (``envs/array_vec.py``) steps an env with its own batched
torch methods, one small operation after another, so a step's cost is the
launches and copies it issues. For shift, friend and sokoban2 at ``--lanes``
lanes this prints and returns:

* the kernels and the host-to-device copies of one engine step, and of one
  step of the tabular trainer (act, engine step, TD update), counted by
  ``torch.profiler`` (``trace_learners.kernel_split``: launches and device
  ms by kernel name, averaged over 20 steps);
* the engine's env-steps/s under ``run_random_reduced`` (uniform actions
  drawn on the card), median of 3 synchronised windows of 256 steps.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from ..agents.tabular import TabularQAgent
from ..envs import make_env
from ..envs.array_vec import ArrayVecEnv
from ..training.tabular import TabularQTrainer
from . import learner_cases as lc
from .trace_learners import kernel_split

ALIASES = ("shift", "friend", "sokoban2")
COPY_PREFIXES = ("Memcpy", "Memset")


def launch_counts(call, reps: int = 20) -> dict:
    """Kernels and copies a call issues, and their device ms, by profiler."""
    split = kernel_split(call, reps=reps)
    out = {"kernels": 0.0, "copies": 0.0, "device_ms": 0.0}
    for name, v in split.items():
        out["copies" if name.startswith(COPY_PREFIXES) else "kernels"] += v["launches_per_call"]
        out["device_ms"] += v["ms_per_call"]
    return out


def engine_rate(vec: ArrayVecEnv, gen, n_steps: int = 256, windows: int = 3) -> float:
    """Median env-steps/s of ``run_random_reduced`` over ``windows``
    synchronised host-clock windows (after one warm-up window)."""
    state = vec.reset(gen)
    state, _ = vec.run_random_reduced(state, gen, 16)
    rates = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, acc = vec.run_random_reduced(state, gen, n_steps)
        float(acc["episodes"])
        torch.cuda.synchronize()
        rates.append(n_steps * vec.n_envs / (time.perf_counter() - t0))
    return statistics.median(rates)


def profile(alias: str, n: int, dev, rate: bool = True) -> dict:
    """The launch counts of one engine step and one tabular trainer step of
    ``alias`` at ``n`` lanes, and (``rate``) the engine's env-steps/s."""
    env = make_env(alias)
    vec = ArrayVecEnv(env, n, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = [vec.reset(gen)]

    def engine_step():
        a = torch.randint(0, env.n_actions, (n,), dtype=torch.int32, generator=gen, device=dev)
        state[0], _ = vec.step(state[0], a, generator=gen)

    trainer = TabularQTrainer(TabularQAgent(env, lr=0.2), vec)
    tab = list(trainer.init(gen))

    def trainer_step():
        tab[0], tab[1], _ = trainer.train_chunk(tab[0], tab[1], gen, 1)

    result = {"lanes": n, "engine_step": launch_counts(engine_step),
              "trainer_step": launch_counts(trainer_step)}
    if rate:
        result["env_steps_per_s"] = engine_rate(vec, gen)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lanes", type=int, default=4096)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_array: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    result = {"card": lc.nvidia_smi("name,power.limit")}
    print(f"card {result['card']}", flush=True)
    for alias in ALIASES:
        result[alias] = r = profile(alias, args.lanes, dev)
        e, t = r["engine_step"], r["trainer_step"]
        print(f"{alias} N={args.lanes}: engine step {e['kernels']:.1f} kernels + "
              f"{e['copies']:.1f} copies ({e['device_ms']:.4f} device ms); tabular trainer "
              f"step {t['kernels']:.1f} + {t['copies']:.1f} ({t['device_ms']:.4f} ms); "
              f"{r['env_steps_per_s']:.0f} env-steps/s", flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
