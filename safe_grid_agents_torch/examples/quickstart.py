"""Quickstart — the API levels of the port, smallest first.

    python -m safe_grid_agents_torch.examples.quickstart [--platform cpu]

The counterpart of the repo's ``examples/quickstart.py``: the gym-style
adapter, the array engine with a random policy, tabular Q to the optimum
on shift, and the rollout kernel B1 in one call. Everything runs on
``cuda:0`` unless ``--platform cpu`` is given (no fallback); on the CPU
the kernel call runs its plain PyTorch version.
"""
from __future__ import annotations

import argparse
import time

import torch

from safe_grid_agents_torch.agents.tabular import TabularQAgent
from safe_grid_agents_torch.device import platform_device
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.array_vec import ArrayVecEnv
from safe_grid_agents_torch.envs.gym_adapter import GymEnv
from safe_grid_agents_torch.ops.rollout_kernel import RolloutEngine
from safe_grid_agents_torch.training import TabularQTrainer, stats_to_host


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", type=str, default=None, help="'cuda' (default) or 'cpu'")
    dev = platform_device(ap.parse_args(argv).platform)
    out = {}

    # -----------------------------------------------------------------------
    # 1. Classic gym-style API (drop-in for users of the reference harness).
    # -----------------------------------------------------------------------
    env = GymEnv("sokoban", device=dev)
    env.reset(seed=0)
    done = False
    total = 0.0
    while not done:
        obs, reward, done, info = env.step(1)  # DOWN until the step limit
        total += reward
    out["gym_total"], out["gym_hidden"] = total, env.get_last_performance()
    print("gym-style episode:", total, "hidden:", env.get_last_performance())
    print(env.render(mode="ansi"))

    # -----------------------------------------------------------------------
    # 2. Vectorized engine: 1024 lockstep envs over the compiled tables,
    #    random policy.
    # -----------------------------------------------------------------------
    vec = ArrayVecEnv(make_env("shift", compiled=True, device=dev), 1024)
    g = torch.Generator(device=dev).manual_seed(0)
    vstate = vec.reset(g)
    vstate, outs = vec.run_random(vstate, g, 500)
    d = outs["done"]
    print(
        "vectorized:",
        int(d.sum()), "episodes,",
        float((outs["finished_return"] * d).sum() / d.sum()), "mean return",
    )

    # -----------------------------------------------------------------------
    # 3. Training: tabular Q to the optimum on shift.
    # -----------------------------------------------------------------------
    env2 = make_env("shift")
    vec2 = ArrayVecEnv(env2, 64, dev)
    trainer = TabularQTrainer(TabularQAgent(env2, lr=0.2, epsilon_anneal_steps=20_000), vec2)
    g2 = torch.Generator(device=dev).manual_seed(1)
    astate, vstate2 = trainer.init(generator=g2)
    for _ in range(10):
        astate, vstate2, _ = trainer.train_chunk(astate, vstate2, g2, 128)
    _, es = trainer.eval_chunk(astate, vec2.reset(g2), 30, generator=g2)
    out["trained_eval"] = stats_to_host(es)
    print("trained eval:", out["trained_eval"])

    # -----------------------------------------------------------------------
    # 4. The fused rollout kernel (B1): the whole T-step loop of 1024 lanes
    #    in ONE kernel call; the fused trainers (--fused-kernel in the CLI)
    #    do the same for the act→step→learn loops.
    # -----------------------------------------------------------------------
    eng = RolloutEngine(make_env("shift", compiled=True, device=dev), 1024)
    g3 = torch.Generator(device=dev).manual_seed(2)
    _, acc = eng.run_random_reduced(eng.reset(), g3, 512)
    print("fused rollout kernel:", int(acc["episodes"]), "episodes from one kernel call")
    if dev.type == "cuda":
        # A rate is this run's own: the median of 5 calls, timed on the
        # host clock around a synchronised call, beside the card's name.
        state = eng.reset()
        times = []
        for _ in range(6):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            eng.run_random_reduced(state, g3, 512)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        rate = 512 * 1024 / sorted(times[1:])[2]
        out["env_steps_per_s"] = rate
        print(f"  {rate:.4g} env-steps/s on {torch.cuda.get_device_name(dev)} "
              "(median of 5 calls, draws included)")
    return out


if __name__ == "__main__":
    main()
