"""Weak scaling and all-reduce bytes of ``DPTrainer``: the counterpart of
the repo's ``tools/scale.py``, with its shapes, rows and table.

    python -m safe_grid_agents_torch.tools.scale [--families tabular,dqn,ppo,crmdp] \\
        [--devices 1,2,4,8] [--json] [-q] [--platform cpu]

For each family and device count W, one chunk of ``CHUNK`` steps of
``DPTrainer`` over ``make_mesh`` runs with ``ENVS_PER_DEV · W`` lanes:

1. **Weak scaling.** Per-device env work is constant as W grows (the lanes
   never talk), and the global stats are exact multiples.
2. **Communication volume, counted.** The reference parses the compiled
   HLO for all-reduce sites and multiplies by their loop counts; eager
   PyTorch has no program to parse, so the port counts instead: every psum
   and pmean goes through ``parallel/collectives.py::_all_reduce_``, whose
   ``all_reduce_counts`` (calls and bytes, one rank's) are zeroed before
   the chunk and read after it. The counted bytes must equal the
   reference's analytic per-chunk model (``analytic`` below, the
   reference's own formulas) within 5%, at every W: the port's trainers
   issue their collectives at W = 1 too (a group of one rank), so the
   counter reads the same calls at every W. The call counts differ from
   the reference's HLO site counts (``EXPECTED_CALLS``): the port ravels a
   gradient and its loss (a TD table, its counts and the lane count) into
   ONE all-reduce per update, and an eager loop issues a call per
   iteration where HLO shows one site per loop body. CRMDP's attribution
   sums its corruption deltas as int64 fixed point ([S] × 8 bytes against
   the reference's 3 · [S] × 4), inside the 5%. Tabular Q sums its TD
   table, its counts and the lane count as int64 (exact fixed point,
   ``agents/tabular.py``): twice the reference's float32 bytes a step
   (``port_payload``).
3. **The scaling model**, as the reference states it: per chunk the
   payload is constant (parameter or table size) while compute grows with
   the local lanes.

Ranks: gloo processes of the CPU (``launch.spawn``; W = 1 joins a group of
one in this process) by default; on the card (``--platform cuda``, the
default) W = 1 is one NCCL rank and W > 1 are gloo ranks sharing the card,
as ``chip_smoke.py`` phases 9 and 10 run them on a one-card host.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..agents.crmdp import PPOCRMDPAgent
from ..agents.dqn import DQNAgent
from ..agents.ppo import PPOAgent
from ..agents.tabular import TabularQAgent
from ..device import platform_device
from ..envs import make_env
from ..envs.array_vec import ArrayVecEnv
from ..parallel import launch
from ..parallel.collectives import all_reduce_counts
from ..parallel.dp import DPTrainer
from ..parallel.mesh import make_mesh
from ..training import CRMDPTrainer, DQNTrainer, PPOTrainer, TabularQTrainer

CHUNK = 16
ENVS_PER_DEV = 8
TOL = 0.05


def _param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in params.values())


def _family(name: str, n_dev: int, device):
    """(trainer over the global lanes, analytic per-chunk all-reduce bytes,
    the port's all-reduce calls a chunk, note)."""
    n_envs = ENVS_PER_DEV * n_dev
    if name == "tabular":
        env = make_env("shift")
        tr = TabularQTrainer(TabularQAgent(env), ArrayVecEnv(env, n_envs, device))
        table = env.num_states * env.n_actions * 4
        # per step: td_sum + cnt ([S,A] f32 each) + n; + stats psum.
        analytic = CHUNK * (2 * table + 4) + 5 * 4
        calls = CHUNK + 1
        note = f"2×[S,A] table psum/step (S={env.num_states})"
    elif name == "dqn":
        env = make_env("sokoban")
        agent = DQNAgent(env, hidden=(128, 128), batch_size=32, replay_capacity=64 * n_dev)
        tr = DQNTrainer(agent, ArrayVecEnv(env, n_envs, device), updates_per_chunk=CHUNK)
        p = _param_bytes(agent.init("cpu").params)
        analytic = CHUNK * (p + 4) + 5 * 4  # grads+loss per update; stats
        calls = CHUNK + 1
        note = f"grad pmean/update ({p/1e3:.0f} KB params)"
    elif name in ("ppo", "crmdp"):
        if name == "ppo":
            env = make_env("island")
            agent = PPOAgent(env, net="mlp", hidden=(128, 128))
            tr = PPOTrainer(agent, ArrayVecEnv(env, n_envs, device))
            extra, extra_calls, noteplus = 0, 0, ""
        else:
            env = make_env("corners")
            agent = PPOCRMDPAgent(env, hidden=(128, 128))
            tr = CRMDPTrainer(agent, ArrayVecEnv(env, n_envs, device))
            extra = 3 * env.num_states * 4  # corruption NLMS delta pmean
            extra_calls, noteplus = 1, " + corruption table"
        p = _param_bytes(agent.init("cpu").params)
        n_mb = agent.epochs * agent.n_minibatches
        analytic = n_mb * (p + 4) + 2 * 4 + extra + 5 * 4
        calls = n_mb + 2 + extra_calls  # + whitening moments, stats
        note = f"grad pmean/minibatch ×{n_mb} ({p/1e3:.0f} KB params){noteplus}"
    else:
        raise ValueError(name)
    return tr, analytic, calls, note


def port_payload(name: str, analytic: int) -> int:
    """The port's all-reduce bytes a chunk from the reference's ``analytic``
    model: tabular Q's per-step payload in int64, 8 bytes an entry where
    the reference's carries 4 (the stats' 5 × 4 bytes alike); the other
    families' as the reference's."""
    if name == "tabular":
        return 2 * (analytic - 5 * 4) + 5 * 4
    return analytic


# The port's all-reduce calls a chunk, by family (``_family``): one a step
# (tabular) or an update (dqn), one a minibatch update (ppo, crmdp), the
# whitening moments, CRMDP's attribution and the stats.
EXPECTED_CALLS = {"tabular": CHUNK + 1, "dqn": CHUNK + 1, "ppo": 16 + 2, "crmdp": 16 + 3}


def rank_chunk(name: str, n_dev: int, platform: str) -> dict:
    """One rank's chunk of ``name`` at world size ``n_dev`` (joined group):
    its stats, loss, all-reduce calls and bytes."""
    rank_dev = torch.device("cuda", 0) if platform == "cuda" else torch.device("cpu")
    group = make_mesh(device=rank_dev)
    tr, analytic, calls, note = _family(name, n_dev, group.device)
    dp = DPTrainer(tr, group)
    g = torch.Generator(device=group.device).manual_seed(1 + group.rank)
    astate, vstate = dp.init(seed=0, generator=g)
    all_reduce_counts.reset()
    t0 = time.perf_counter()
    out = dp.train_chunk(astate, vstate, g, CHUNK)
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    wall = time.perf_counter() - t0
    return {"env_steps": float(out[2].env_steps),
            "loss": float(out[3]) if len(out) > 3 else None,
            "calls": all_reduce_counts.calls, "bytes": all_reduce_counts.bytes,
            "analytic": analytic, "expected_calls": calls, "note": note, "wall_s": wall,
            "backend": group.backend}


def run_width(name: str, n_dev: int, platform: str) -> dict:
    """Rank 0's ``rank_chunk`` at world size ``n_dev``: one rank joins a
    group of one in this process (NCCL on the card, else gloo), more are
    spawned gloo ranks."""
    if n_dev == 1:
        with launch.single_rank("nccl" if platform == "cuda" else "gloo"):
            return rank_chunk(name, 1, platform)
    return launch.spawn(rank_chunk, n_dev, (name, n_dev, platform), backend="gloo",
                        timeout=600)[0]


def run_family(name: str, n_devs, platform: str, verbose: bool) -> list:
    rows = []
    for n_dev in n_devs:
        r = run_width(name, n_dev, platform)
        env_steps, analytic = r["env_steps"], r["analytic"]
        assert r["calls"] == EXPECTED_CALLS[name] == r["expected_calls"], (
            f"{name}@{n_dev}: {r['calls']} all-reduces in the chunk, expected "
            f"{EXPECTED_CALLS[name]} — a collective was gained or lost")
        want = port_payload(name, analytic)
        assert abs(want - r["bytes"]) <= TOL * want, (
            f"{name}@{n_dev}: modelled {want} B/chunk vs counted {r['bytes']} B "
            "— models diverged")
        assert env_steps == CHUNK * ENVS_PER_DEV * n_dev, (name, n_dev, env_steps)
        assert r["loss"] is None or r["loss"] == r["loss"], f"{name}: NaN loss at {n_dev} dev"
        rows.append({
            "family": name,
            "devices": n_dev,
            "env_steps_per_chunk": env_steps,
            "env_steps_per_device": env_steps / n_dev,
            "allreduce_bytes_per_chunk": analytic if n_dev > 1 else 0,
            "allreduce_bytes_per_env_step": (analytic / env_steps) if n_dev > 1 else 0.0,
            "allreduce_calls": r["calls"],
            "allreduce_counted_bytes": r["bytes"],
            "backend": r["backend"],
            "chunk_wall_s": r["wall_s"],
            "note": r["note"],
        })
        if verbose:
            print(f"  {name} @ {n_dev} dev: steps {env_steps:.0f} "
                  f"({env_steps/n_dev:.0f}/dev), {r['calls']} all-reduce calls "
                  f"counted ({r['bytes']/1e3:.1f} KB), analytic {analytic/1e3:.1f} KB/chunk",
                  file=sys.stderr)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default="tabular,dqn,ppo,crmdp")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--json", action="store_true", help="emit JSON rows only")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--platform", type=str, default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    platform = platform_device(args.platform).type
    n_devs = [int(x) for x in args.devices.split(",")]
    rows = []
    for fam in args.families.split(","):
        rows += run_family(fam, n_devs, platform, verbose=not args.quiet)

    if args.json:
        for r in rows:
            print(json.dumps(r))
        return rows

    print("\n## Weak scaling + communication volume "
          f"(chunk = {CHUNK} steps, {ENVS_PER_DEV} envs/device)\n")
    print("| family | devices | env-steps/chunk | per-device | all-reduce "
          "B/chunk | B/env-step | AR calls counted | collective payload |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['family']} | {r['devices']} | "
              f"{r['env_steps_per_chunk']:.0f} | "
              f"{r['env_steps_per_device']:.0f} | "
              f"{r['allreduce_bytes_per_chunk']:,} | "
              f"{r['allreduce_bytes_per_env_step']:.1f} | "
              f"{r['allreduce_calls']} | {r['note']} |")
    print("""
Reading the table:
* per-device env work is CONSTANT as devices grow (weak scaling) — collect
  has zero cross-device traffic; only learner reductions are all-reduced;
* the all-reduce payload per chunk does NOT grow with device count (grad /
  table size only), so comm time is flat while aggregate compute scales;
* the counted bytes of every row equal the analytic model within 5%.""")
    return rows


if __name__ == "__main__":
    main()
