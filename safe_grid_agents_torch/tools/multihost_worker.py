"""One process of a multi-process data-parallel run (BASELINE config 5's
"N ≥ 2 hosts" without a cluster): the port's counterpart of the reference's
``tools/multihost_worker.py``.

Started once per process under a launcher's variables, on the CPU:

    MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> WORLD_SIZE=2 RANK=<i> LOCAL_RANK=<i> \\
        python -m safe_grid_agents_torch.tools.multihost_worker [--sweep]

Each process joins the gloo group (``parallel.multihost``), owns its share
of the lanes, and trains one ``DPTrainer``-wrapped PPO chunk whose gradient
all-reduce crosses the process boundary. It prints one JSON line of what
every process must agree on: the loss, a parameter checksum and the
summed statistics (``--sweep``: for every env alias).
"""
from __future__ import annotations

import argparse
import datetime
import json

import torch
import torch.distributed as dist

from ..agents.ppo import PPOAgent
from ..envs import ALL_ENV_ALIASES, make_env
from ..envs.array_vec import ArrayVecEnv
from ..parallel import make_mesh, multihost
from ..parallel.dp import DPTrainer, rank_seed
from ..training import PPOTrainer


def chunk(alias: str, group, lanes_per_rank: int, hidden: int, n_steps: int = 4) -> dict:
    """One DP PPO chunk on ``alias``: its loss, parameter checksum and the
    chunk's summed statistics."""
    env = make_env(alias)
    n = lanes_per_rank * group.world_size
    agent = PPOAgent(env, hidden=(hidden, hidden), epochs=2, n_minibatches=2)
    trainer = DPTrainer(PPOTrainer(agent, ArrayVecEnv(env, n, group.device)), group)
    g = torch.Generator(device=group.device).manual_seed(rank_seed(1, group.rank))
    astate, vstate = trainer.init(seed=0, generator=g)
    astate, _, stats, loss = trainer.train_chunk(astate, vstate, g, n_steps)
    checksum = sum(float(p.double().abs().sum()) for p in astate.params.values())
    return {"loss": float(loss), "param_checksum": checksum,
            "env_steps": float(stats.env_steps), "episodes": float(stats.episodes),
            "return_sum": float(stats.return_sum), "hidden_sum": float(stats.hidden_sum)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="one chunk on every env alias (BASELINE config 5's letter: all "
                         "safety gridworlds sharded over N >= 2 processes)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if not multihost.ensure_initialized("cpu", datetime.timedelta(seconds=args.timeout)):
        raise SystemExit("no launcher variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    group = make_mesh()
    head = {"process": group.rank, "n_processes": group.world_size}
    if args.sweep:
        report = {alias: chunk(alias, group, 8, 16) for alias in ALL_ENV_ALIASES}
        print(json.dumps({**head, "aliases": report}), flush=True)
    else:
        print(json.dumps({**head, **chunk("shift", group, 16, 32)}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
