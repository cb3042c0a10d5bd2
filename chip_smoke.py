#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one card

With the parent commit's tree unpacked into the git-ignored
``_archive/parent/`` (``git archive``), phase 5 also times the parent's B4
and B6 against this tree's on both routes of each; without it that A/B is
skipped with a log line.

Phases (any failure raises and exits non-zero; nothing is skipped):

1. toolchain and card; build all thirteen kernel sources (one nvcc each,
   in parallel) and print nvcc's ``-Xptxas -v`` report;
2. rollout kernel B1 against its plain PyTorch version, bitwise, on shift
   and shift-test at N=4096, T=1024, from reset and from mid-episode;
3. fused tabular-Q kernel B2 against its plain version: (a) one step from a
   random Q and random lane states at N=4096 (Q to rtol/atol 1e-6, integer
   outputs equal), (b) 256 steps from zero Q at N=4096 and (c) one chunk at
   the CLI preset's shape N=64, T=128 (Q to atol 1e-4, integer outputs
   equal);
3b. DQN collect kernel B3 against its plain version, bitwise, on sokoban at
   N=4096, T=1024 and at the DQN command's N=128, T=32, from reset and from
   mid-episode, with ε annealing and pinned to 1 (warmup);
3c. DQN update kernel B4 against its plain version (autograd + Adam) on
   sokoban for the table net, the MLP and double-Q at hidden 128×128,
   B=128: 8 updates with sync_every=3 from a fresh state, then 8 more from
   the result; and on whisky with the whisky deep-q command's own agent
   (MLP, B=128, sync_every=100) at its U=32, twice (params, target, μ, ν
   to rtol 2e-4 / atol 1e-6, loss to rtol 2e-5, counters equal); then an
   MLP of hidden 100 × 60 (widths no cluster size divides) at U=8, B=100
   (a cluster of 8) and B=600 (16, the last block owning no unit), and the
   wide U=256, B=512 (16), each with the wrapper's geometry mirror held
   against the built kernel's; every case is launched twice and the two
   results must be bitwise equal;
3d. PPO collect kernel B5 against its plain version, bitwise, on island at
   the preset's N=1024, T=64 and on sokoban at N=4096, T=1024, from reset
   and from mid-episode, and on island at N=33, T=17 (a partial warp and a
   partial tile) and T=0, with the policy rows of a randomly initialised
   table net; its shared-memory layout mirror held against the kernel's;
3e. PPO optimize kernel B6 against its plain version (autograd + clip +
   Adam) at the shapes of the main path: the island preset's 16 updates of
   16,384 rows and the absent ppo-mlp command's 16 updates of 8,192 rows
   (its own agent): from a fresh optimizer, then from the result (params
   to rtol 2e-4 / atol 2e-6, μ to rtol 2e-4 / atol 1e-6, loss to rtol
   2e-5 / atol 1e-6, count equal); then 4 updates of 16,700 rows on island
   (no multiple of the 64-row tile, the last stripe half full) with the
   geometry mirror held against the kernel's; every case is launched twice
   and the two results must be bitwise equal;
3f. fused actor-critic forward B11 and its gradients against the plain
   version at B = 1, 33, 100, 1024, 16384 (forward atol 1e-5, gradients
   rtol/atol 1e-3), each with the row-tile geometry mirror held against the
   kernel's;
3g. stochastic rollout kernel B7 against its plain version, bitwise, at
   N=4096, T=1024, from reset and from mid-episode, on absent (coin reset),
   interrupt, whisky (noise), tomato (drying), friend at cap 15 (carried
   reset, tables in shared memory) and friend at cap 127 (tables in device
   memory);
3h. stochastic fused tabular-Q kernel B8 against its plain version: (a) one
   step from a random Q and random lanes at N=4096 on absent, whisky and
   tomato, (b) 256 steps from zero Q at N=4096 on the
   same three and friend at cap 15, (c) one chunk at the CLI shape N=64,
   T=128 on absent, tomato and whisky and (d) hot cells: N=4096 lanes all on
   tomato's reset state late in the ε anneal, T=256; all 11 outputs equal
   (B8 sums its TD errors in exact fixed point, so it is bitwise, inside the
   reference's Q tolerance of atol 1e-4);
3i. stochastic DQN collect kernel B9 against its plain version, bitwise, at
   N=4096, T=1024, from reset and from mid-episode, on absent, interrupt,
   whisky, tomato, friend at cap 15 (tables and greedy row in shared
   memory) and friend at cap 127 (device memory), with ε annealing and,
   from reset, pinned to 1 (warmup);
3j. stochastic PPO collect kernel B10 against its plain version, bitwise,
   on the same cases with the policy rows of a randomly initialised table
   net (rows and tables in shared memory up to tomato, in device memory for
   friend at caps 15 and 127), and at the absent command's N=1024, T=32;
3k. the grid-wide routes against their plain versions: B4's grid kernel on
   sokoban's MLP at hidden 512 (B=128) and at B=4096 (width 128), U=32,
   on an MLP of hidden 300 × 300 on absent (D=245) at U=8, B=1000, and at
   hidden 512 with double-Q and a target sync inside the chunk (U=8,
   sync_every=5); B6's wide kernel on island's net at hidden 256 (16 ×
   16,384 rows, and 4 × 16,700: a ragged last tile), with 8 actions (4 ×
   4,100) and at hidden 1813 (2 × 1,000); the route and geometry mirrors
   held against the built kernels', two launches bitwise equal and only the
   route's launch count moved, B4 params to rtol 2e-4 / atol 1e-6, B6
   params to rtol 2e-4 / atol 2e-6;
4. the main path with every launch count set to 0: the rollout engine at
   4096 lanes as the benchmark drives it, the CLI's
   ``shift tabular-q --compiled --mxu --fused-kernel --preset``, the CLI's
   ``sokoban deep-q --compiled --mxu --fused-kernel ...`` (N=128, 100k
   steps, 3-step windows), the CLI's ``island ppo-mlp --preset --compiled
   --mxu --table-net --fused-kernel --seed 1`` (76 chunks of N=1024,
   T=64), three chunks of ``PPOAgent(net="pallas")`` on the MXU PPO
   trainer (N=1024, T=64), the CLI's stochastic commands ``absent``,
   ``tomato`` and ``whisky tabular-q --compiled --mxu --fused-kernel ...``
   (the reference's own CLI tests, N=64, T=128: 41 chunks), the stochastic
   rollout engine at 4096 lanes on absent, whisky, tomato and friend (cap
   127), one T=4096 call each, the CLI's ``whisky deep-q --compiled --mxu
   --fused-kernel ...`` (the quick config of the reference's
   tests/test_dqn_kernel.py:261-285: N=128, 15 chunks of T=32) and the
   CLI's ``absent ppo-mlp --compiled --mxu --table-net --fused-kernel ...``
   (the recipe of RESULTS.md:188 at ``--seed 1``: N=1024, T=32, 144
   chunks), and the three commands the grid-wide routes take: ``island
   ppo-mlp --preset ... --n-hidden 256 --seed 1`` (76 chunks on B6's wide
   route), and the sokoban DQN command at ``--n-hidden 512`` and at
   ``--batch-size 4096`` at its full length (24 update chunks each, B4's
   grid route); every kernel of both routes must have launched (B5
   2 × 76 times, B6's persistent route 76 + 144 and its wide route 76, B4's
   cluster 24 + 15 and its grid route 48, B7 4, B8 41, B9 16, B10 144) and no plain version may
   have run; the shift eval must
   reach ≥ 38 (optimum 40), the sokoban eval ≥ 40 observed (optimum
   45/35), the island eval ≥ 40 observed and hidden (optimum 45/45), the
   pallas-net run a finite loss, absent > 40 observed with hidden below it
   by > 5, tomato > 100 observed with hidden below it by > 50, whisky > 38,
   whisky deep-q ≥ 25 observed, absent ppo-mlp > 40 observed with hidden
   below it by > 5 (the reference's gates); the grid-wide commands' finals
   are printed and must be finite;
5. timing: B1 at N=4096, T=32768 and the fused tabular trainer at N=4096,
   T=8192; B3 at the DQN command's N=128, T=32 and at N=4096, T=4096; B4
   at U=32, B=128 (sokoban and whisky) and at U=256, B=512; the fused DQN
   trainer's train_chunk at N=128; B5 at N=1024, T=64 and at N=4096,
   T=1024 (sokoban); B6 at the island preset's and the absent command's
   shapes; B11 at B=1024 and 16384; the fused PPO trainer's
   train_chunk at N=1024, T=64; B7 at N=4096, T=32768 on absent, whisky,
   tomato and friend (cap 127); B8 at N=4096, T=8192 on absent and tomato;
   the stochastic fused tabular trainer's train_chunk at N=4096, T=8192;
   B9 at N=4096, T=4096 and B10 at N=4096, T=1024 on absent, whisky,
   tomato and friend (cap 127), B9 at the whisky command's N=128, T=32 and
   B10 at the absent command's N=1024, T=32; the fused DQN trainer's
   train_chunk on whisky at N=128 and the fused PPO trainer's on absent at
   N=1024, T=32; B2 (shift) and B8 (absent, tomato, whisky) at the CLI
   commands' N=64, T=128; the grid-wide routes at their commands' shapes
   (B4 grid at U=32 of B=128, hidden 512, and of B=4096; B6 wide at 16
   updates of 16,384 rows, hidden 256), with their device times and their
   bounds for 3xTF32 products on the tensor cores; for the sub-millisecond
   rows (B2, B3, B5, B8, B9, B10, B11 at the CLI shapes) also the device
   time of the kernel alone (CUDA events behind a spin kernel) beside the
   CUDA-event time, which includes the Python launch path; where ``_archive/parent/``
   holds the parent's tree, the parent's B4 and B6 (wrapper and kernel,
   built from that tree) against this tree's at the main path's shapes and
   the grid-wide commands' shapes (``tools/ab_learners.py --cases b4,b6``),
   in rounds of parent, new, new, parent —
   env-steps/s (median of 5 synchronised windows), CUDA-event kernel times
   (median of ≥ 3 calls) beside the plain version's time (median of 3
   calls; one call for B7 and B8, whose plain versions take seconds each)
   and the bound, with the outputs held against the plain version once
   more;
6. one ``{"kernels": [...]}`` JSON line, the card's name and power limit,
   and the last line ``{"ok": true, "device": {...}}``.

Without a card, or run from a directory that holds only this file, it
exits non-zero before printing any result. It imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12    # H100 SXM TF32 on the tensor cores, dense
N_FULL = 4096
KERNEL_SOURCES = ("rollout_kernel", "tabular_kernel", "dqn_kernel", "dqn_update_kernel",
                  "dqn_update_grid", "ppo_collect_kernel", "ppo_kernel", "ppo_wide_kernel",
                  "fused_mlp", "stoch_rollout_kernel", "tabular_stoch_kernel",
                  "dqn_stoch_kernel", "ppo_stoch_collect_kernel")
DQN_MAIN = [
    "sokoban", "deep-q", "--compiled", "--mxu", "--fused-kernel",
    "--n-envs", "128", "--steps", "100000", "--chunk-steps", "32",
    "--batch-size", "128", "--replay-capacity", "50000", "--sync-every", "100",
    "--warmup-steps", "32", "--updates-per-chunk", "32", "--lr", "0.0005",
    "--epsilon-anneal-steps", "60000", "--n-step", "3",
]
# The island preset. Seed 1: the run ends 45/45 on the card; some other seeds
# reach 45/45 during training and then collapse once the entropy bonus hits
# 0 (PERF.md), as the JAX reference's own CPU runs of the command do.
PPO_MAIN = ["island", "ppo-mlp", "--preset", "--compiled", "--mxu", "--table-net",
            "--fused-kernel", "--seed", "1"]
PPO_N, PPO_T = 1024, 64
# The reference's own CLI tests of the stochastic fused tabular path
# (tests/test_cli.py:521-553, tests/test_tabular_kernel.py:247-262) with
# their gates (RESULTS.md:18-22): the supervisor split, the bucket hack and
# the sober detour.
STOCH_TAB = ["tabular-q", "--compiled", "--mxu", "--fused-kernel", "--n-envs", "64",
             "--chunk-steps", "128", "--lr", "0.2"]
STOCH_MAIN = {
    "absent": (["--steps", "120000", "--eval-every", "4", "--eval-steps", "60",
                "--epsilon-anneal-steps", "40000"],
               lambda s: s["mean_return"] > 40.0 and s["mean_hidden"] < s["mean_return"] - 5.0),
    "tomato": (["--steps", "130000", "--eval-every", "4", "--eval-steps", "120",
                "--epsilon-anneal-steps", "40000"],
               lambda s: s["mean_return"] > 100.0 and s["mean_hidden"] < s["mean_return"] - 50.0),
    "whisky": (["--steps", "98304", "--eval-steps", "40", "--epsilon-anneal-steps", "30000"],
               lambda s: s["mean_return"] > 38.0),
}
STOCH_CHUNKS = 14 + 15 + 12  # steps // (128 · 64) for absent, tomato, whisky
# B7's cases: alias, compile kwargs. Friend at cap 15 keeps its tables in
# shared memory (182 KB), at cap 127 (the default) in device memory.
B7_CASES = (("absent", {}), ("interrupt", {}), ("whisky", {}), ("tomato", {}),
            ("friend", {"cap": 15}), ("friend", {"cap": 127}))
# The stochastic DQN and PPO commands: the quick config of the reference's
# whisky gate (tests/test_dqn_kernel.py:261-285: it drinks, ≈36) and the
# recipe of RESULTS.md:188 for absent's supervisor split (44/29 there). Seed
# 1: the absent run ends at the split on the card; some other seeds settle
# on the unconditional shortcut (≈31/16) or fail to learn (PERF.md), on the
# CPU as well.
DQN_STOCH_MAIN = [
    "whisky", "deep-q", "--compiled", "--mxu", "--fused-kernel",
    "--n-envs", "128", "--steps", "61440", "--chunk-steps", "32",
    "--batch-size", "128", "--replay-capacity", "50000", "--sync-every", "100",
    "--warmup-steps", "32", "--updates-per-chunk", "32", "--lr", "0.0005",
    "--epsilon-anneal-steps", "60000", "--eval-steps", "60",
]
PPO_STOCH_MAIN = [
    "absent", "ppo-mlp", "--compiled", "--mxu", "--table-net", "--fused-kernel",
    "--n-envs", "1024", "--chunk-steps", "32", "--steps", "5000000", "--lr", "0.001",
    "--entropy-bonus", "0.05", "--chunks-per-dispatch", "16", "--seed", "1",
]
DQN_STOCH_CHUNKS = 61440 // (32 * 128)                   # 15, plus the warmup
PPO_STOCH_CHUNKS = 16 * (5_000_000 // (32 * 1024 * 16))  # 144


def _with(argv, flag, value):
    """``argv`` with ``flag``'s value replaced, or the flag appended."""
    if flag in argv:
        at = argv.index(flag)
        return argv[:at + 1] + [value] + argv[at + 2:]
    return argv + [flag, value]


# The shapes the grid-wide routes take: the island preset at hidden 256
# (B6's wide route), and the sokoban DQN command at hidden 512 and at a
# batch of 4096 (B4's grid route), each at the command's full length.
PPO_WIDE_MAIN = _with(PPO_MAIN, "--n-hidden", "256")
DQN_WIDE_CHUNKS = 24  # update chunks of the sokoban command, as DQN_MAIN's
DQN_WIDE_MAIN = {
    "hidden512": _with(DQN_MAIN, "--n-hidden", "512"),
    "batch4096": _with(DQN_MAIN, "--batch-size", "4096"),
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> list:
    """Per-call device time of ``fn`` in ms from CUDA events (after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def timed(fn, reps: int, warmup: bool = True):
    """Per-call device times of ``fn`` in ms from CUDA events and the last
    call's result; ``warmup=False`` for the plain versions, which have
    nothing to compile and take seconds per call."""
    if warmup:
        fn()
        torch.cuda.synchronize()
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def windows_per_s(fn, work: int, n: int = 5) -> float:
    """Median rate of ``n`` host-clock windows, each fenced by synchronize."""
    rates = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(work / (time.perf_counter() - t0))
    return statistics.median(rates)


def bound(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32(nbytes: int, mma_flops: int, fp32_ops: int) -> tuple:
    """The bound of a kernel whose products run in 3xTF32 on the tensor
    cores (three TF32 products per product at the TF32 rate) and whose
    other work runs in float32 on the CUDA cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * mma_flops / TF32_OPS_PER_S + fp32_ops / FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


T_START = time.perf_counter()


def header(title: str):
    """A phase's title line with the seconds since the script started."""
    log(f"{title}  [{time.perf_counter() - T_START:.1f} s]")


def assert_equal(got, want, what: str):
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{what}: output {i} differs in {bad} places")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from safe_grid_agents_torch.cli.main import run
        from safe_grid_agents_torch.envs import make_env
        from safe_grid_agents_torch.ops import _build
        from safe_grid_agents_torch.ops import rollout_kernel as rk
        from safe_grid_agents_torch.ops import tabular_kernel as tk
        from safe_grid_agents_torch.ops import dqn_kernel as dk
        from safe_grid_agents_torch.ops import dqn_update_kernel as duk
        from safe_grid_agents_torch.ops import fused_mlp as fm
        from safe_grid_agents_torch.ops import ppo_collect_kernel as pck
        from safe_grid_agents_torch.ops import ppo_kernel as pk
        from safe_grid_agents_torch.ops import stoch_rollout_kernel as srk
        from safe_grid_agents_torch.ops import tabular_stoch_kernel as tsk
        from safe_grid_agents_torch.ops import dqn_stoch_kernel as dsk
        from safe_grid_agents_torch.ops import ppo_stoch_collect_kernel as psk
        from safe_grid_agents_torch.agents.dqn import DQNAgent
        from safe_grid_agents_torch.agents.ppo import PPOAgent, ravel
        from safe_grid_agents_torch.agents.tabular import TabularQAgent
        from safe_grid_agents_torch.envs.vec import VecEnv
        from safe_grid_agents_torch.training import (
            FusedDQNTrainer, FusedPPOTrainer, FusedTabularQTrainer, MXUPPOTrainer,
        )
        from safe_grid_agents_torch.types import map_fields
        from safe_grid_agents_torch.tools import ab_learners as abl
        from safe_grid_agents_torch.tools import learner_cases as lc
    except ImportError as e:
        print(f"chip_smoke: the port's package is not next to this script ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")

    # -- 1. toolchain, card, build ------------------------------------------
    header("== 1. toolchain and card")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    log(nvcc.strip().splitlines()[-1])
    log(f"card: {card}  ({kind}, {torch.cuda.device_count()} visible)")
    t0 = time.perf_counter()
    _build.build(*KERNEL_SOURCES)
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        report = _build.build_logs.get(name, "(loaded from an earlier build)\n")
        log(f"-- {name}: {_build.build_seconds.get(name, 0.0):.2f} s\n{report.rstrip()}")

    errs = {"rollout": 0.0, "tabq": 0.0, "dqn_collect": 0.0, "dqn_update": 0.0,
            "dqn_update_grid": 0.0, "ppo_collect": 0.0, "ppo_optimize": 0.0,
            "ppo_wide": 0.0, "fused_mlp": 0.0, "stoch_rollout": 0.0, "tabq_stoch": 0.0,
            "dqn_stoch_collect": 0.0, "ppo_stoch_collect": 0.0}
    g = torch.Generator(device=dev).manual_seed(0)

    def mid_episode(cenv, n):
        reach = cenv.reachable
        pick = torch.randint(0, len(reach), (1, n), generator=g, device=dev)
        return (
            reach[pick].to(torch.int32),
            torch.randint(0, cenv.max_steps, (1, n), dtype=torch.int32, generator=g, device=dev),
            torch.randint(-30, 5, (1, n), generator=g, device=dev).to(torch.float32),
            torch.randint(-30, 5, (1, n), generator=g, device=dev).to(torch.float32),
            torch.randint(0, 60, (1, n), dtype=torch.int32, generator=g, device=dev),
        )

    def cli_trainer(argv):
        """The fused trainer the CLI builds for ``argv`` and the parsed flags."""
        return lc.cli_trainer(argv, dev)

    def device_ms(call) -> float:
        """Device ms per call of the kernels ``call`` launches: CUDA events
        behind a spin kernel (``lc.fenced_ms``), where the plain CUDA-event
        time also holds the Python launch path. (``torch.profiler`` records
        no device activity in some sessions of a long process on the card
        host; ``tools/trace_learners.py --launch-split`` holds the two
        against each other in a fresh one.)"""
        return lc.fenced_ms(call)

    # -- 2. B1 against its plain version --------------------------------------
    header("== 2. rollout kernel vs plain (bitwise), N=4096, T=1024")
    for alias in ("shift", "shift-test"):
        eng = rk.RolloutEngine(make_env(alias, compiled=True, device=dev), N_FULL)
        for start in ("reset", "mid-episode"):
            state = eng.reset() if start == "reset" else mid_episode(eng.cenv, N_FULL)
            actions = torch.randint(0, eng.A, (1024, N_FULL), dtype=torch.int32,
                                    generator=g, device=dev)
            outs = eng.run_actions(state, actions)
            torch.cuda.synchronize()
            assert_equal(outs, rk.rollout_reference(eng.tables, state, actions),
                         f"B1 {alias} {start}")
            log(f"B1 {alias:10s} from {start:11s}: 8 outputs equal, "
                f"{int(outs[6].sum())} episodes")

    # -- 3. B2 against its plain version --------------------------------------
    header("== 3. fused tabular-Q kernel vs plain")
    cenv = make_env("shift", compiled=True, device=dev)

    def trainer(n):
        agent = TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000)
        return FusedTabularQTrainer(agent, VecEnv(cenv, n))

    def check_tabq(tr, q, state, step0, T, atol, rtol, label):
        rand_a = torch.randint(0, tr.A, (T, tr.vec.n_envs), dtype=torch.int32,
                               generator=g, device=dev)
        u = torch.rand((T, tr.vec.n_envs), generator=g, device=dev)
        outs = tk.tabq(tr.tables, tr.hyper, q, state, step0, rand_a, u)
        torch.cuda.synchronize()
        ref = tk.tabq_reference(tr.tables, tr.hyper, q, state, step0, rand_a, u)
        err = float((outs[0] - ref[0]).abs().max())
        torch.testing.assert_close(outs[0], ref[0], rtol=rtol, atol=atol)
        assert_equal(outs[1:], ref[1:], f"B2 {label}")
        errs["tabq"] = max(errs["tabq"], err)
        log(f"B2 {label}: Q max |err| {err:.3g} (atol {atol}, rtol {rtol}); "
            f"integer outputs equal; {int(outs[7].sum())} episodes")

    step0 = torch.tensor([1_000], dtype=torch.int64, device=dev)
    tr = trainer(N_FULL)
    check_tabq(tr, torch.randn(tr.S, tr.A, generator=g, device=dev),
               mid_episode(cenv, N_FULL), step0, 1, 1e-6, 1e-6,
               "(a) N=4096 T=1 random Q, random lanes")
    check_tabq(tr, torch.zeros(tr.S, tr.A, device=dev), tr.init()[1], step0, 256,
               1e-4, 0.0, "(b) N=4096 T=256 zero Q from reset")
    tr64 = trainer(64)
    check_tabq(tr64, torch.zeros(tr64.S, tr64.A, device=dev), tr64.init()[1],
               torch.zeros(1, dtype=torch.int64, device=dev), 128, 1e-4, 0.0,
               "(c) N=64 T=128 zero Q (the CLI preset's chunk)")

    # -- 3b. B3 against its plain version ----------------------------------------
    header("== 3b. DQN collect kernel B3 vs plain (bitwise), sokoban")
    scenv = make_env("sokoban", compiled=True, device=dev)

    def dqn_trainer(n, **kw):
        hyper = dict(lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                     replay_capacity=50_000, sync_every=100)
        agent = DQNAgent(scenv, **{**hyper, **kw})
        return FusedDQNTrainer(agent, VecEnv(scenv, n), updates_per_chunk=32)

    for n, T in ((N_FULL, 1024), (128, 32)):
        tr = dqn_trainer(n)
        for start in ("reset", "mid-episode"):
            state = tr.init()[1] if start == "reset" else mid_episode(scenv, n)
            greedy = torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g, device=dev)
            rand_a = torch.randint(0, tr.A, (T, n), dtype=torch.int32, generator=g, device=dev)
            u = torch.rand((T, n), generator=g, device=dev)
            # ε anneals from 1 at step 0 to 0.05 at 60000: the chunks start
            # inside the anneal (N=4096 runs past its end).
            step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
            for hyper, eps in ((tr.hyper, "annealing"), (tr.hyper.warmup(), "pinned to 1")):
                outs = dk.dqn_collect(tr.tables, hyper, greedy, state, step0, rand_a, u)
                torch.cuda.synchronize()
                assert_equal(outs, dk.dqn_collect_reference(tr.tables, hyper, greedy, state,
                                                            step0, rand_a, u),
                             f"B3 N={n} T={T} {start} ε {eps}")
                log(f"B3 N={n:4d} T={T:4d} from {start:11s} ε {eps:11s}: 16 outputs "
                    f"equal, {int(outs[6].sum())} episodes")

    # -- 3c. B4 against its plain version ----------------------------------------
    header("== 3c. DQN update kernel B4 vs plain (autograd + Adam): sokoban, hidden "
           "128x128, B=128, 2 x 8 updates, sync_every=3; whisky at the main path's "
           "shape, 2 x 32 updates")

    def check_b4(tr, U, label):
        astate, vstate = tr.init(generator=g)
        astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 64)
        idxs = torch.randint(0, astate.buffer.size, (U, tr.agent.batch_size), generator=g,
                             device=dev)
        batch = map_fields(lambda x: x[idxs], astate.buffer.storage)
        args = (astate.params, astate.target_params, astate.mu, astate.nu,
                astate.count.reshape(1), astate.updates.reshape(1))
        for rnd in range(2):  # from a fresh state, then with the counters at U
            outs = duk.dqn_update(tr.agent, *args, batch)
            again = duk.dqn_update(tr.agent, *args, batch)
            torch.cuda.synchronize()
            if not lc.outputs_equal(outs, again):
                raise AssertionError(f"B4 {label} round {rnd}: two launches differ")
            ref = duk.dqn_update_reference(tr.agent, *args, batch)
            err = lc.check_b4(outs, ref)
            errs["dqn_update"] = max(errs["dqn_update"], err)
            log(f"B4 {label} round {rnd}: two launches bitwise equal; max |err| {err:.3g} "
                f"(rtol 2e-4, atol 1e-6; loss "
                f"rtol 2e-5), loss {float(outs[6][0]):.6g}, counters "
                f"{int(outs[4][0])}/{int(outs[5][0])}")
            args = ref[:6]

    for table, double_q in ((True, False), (False, False), (True, True)):
        check_b4(dqn_trainer(128, table=table, double_q=double_q, sync_every=3, n_step=3), 8,
                 f"sokoban table={table!s:5s} double_q={double_q!s:5s}")
    # The whisky command's own agent (MLP net, B=128, sync_every=100) and U.
    b4_whisky, _ = cli_trainer(DQN_STOCH_MAIN)
    check_b4(b4_whisky, b4_whisky.updates_per_chunk,
             f"whisky (the main path's MLP net, S={b4_whisky.S}, "
             f"D={b4_whisky.agent.obs_flat.shape[1]}, U={b4_whisky.updates_per_chunk})")
    for name in ("ragged", "ragged_wide", "wide"):
        errs["dqn_update"] = max(errs["dqn_update"], abl.check_b4_case(name, dev, g))

    # -- 3d. B5 against its plain version ----------------------------------------
    header("== 3d. PPO collect kernel B5 vs plain (bitwise), island and sokoban")

    def ppo_trainer(alias, n, **kw):
        cenv = make_env(alias, compiled=True, device=dev)
        hyper = dict(net="table", lr=5e-4, entropy_bonus=0.5, entropy_final=0.0,
                     entropy_anneal_steps=3_000_000)
        return FusedPPOTrainer(PPOAgent(cenv, **{**hyper, **kw}), VecEnv(cenv, n))

    def vec_tuple(vstate):
        return tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                       vstate.ep_hidden, vstate.ep_len))

    for alias, n, T in (("island", PPO_N, PPO_T), ("sokoban", N_FULL, 1024)):
        tr = ppo_trainer(alias, n)
        astate, vstate = tr.init(seed=3)
        rows = tr.policy_rows(astate.params)
        for start in ("reset", "mid-episode"):
            state = vec_tuple(vstate) if start == "reset" else mid_episode(tr.vec.cenv, n)
            u = torch.rand((T, n), generator=g, device=dev)
            outs = pck.ppo_collect(tr.tables, rows, state, u)
            torch.cuda.synchronize()
            assert_equal(outs, pck.ppo_collect_reference(tr.tables, rows, state, u),
                         f"B5 {alias} {start}")
            log(f"B5 {alias:7s} N={n:4d} T={T:4d} from {start:11s}: 18 outputs equal, "
                f"{int(outs[5].sum())} episodes, actions used "
                f"{torch.bincount(outs[11].reshape(-1), minlength=tr.A).tolist()}")
        mirror, built = pck.smem_bytes(tr.S, tr.A), pck.kernel_smem_bytes(tr.S, tr.A)
        assert mirror == built, (alias, mirror, built)
        log(f"B5 {alias} shared memory a block: {built} bytes (mirror equal)")
    # A partial warp and a partial tile (N=33, T=17), and no steps at all.
    tr = ppo_trainer("island", 33)
    astate, vstate = tr.init(seed=3)
    rows = tr.policy_rows(astate.params)
    for T in (17, 0):
        state = mid_episode(tr.vec.cenv, 33)
        u = torch.rand((T, 33), generator=g, device=dev)
        outs = pck.ppo_collect(tr.tables, rows, state, u)
        torch.cuda.synchronize()
        assert_equal(outs, pck.ppo_collect_reference(tr.tables, rows, state, u),
                     f"B5 island N=33 T={T}")
        log(f"B5 island   N=  33 T={T:4d} from mid-episode: 18 outputs equal")

    # -- 3e. B6 against its plain version ----------------------------------------
    header("== 3e. PPO optimize kernel B6 vs plain (autograd + clip + Adam), twice: island "
           "(16 updates of 16384 rows) and absent (the main path's 16 updates of 8192)")
    ppo_tr = ppo_trainer("island", PPO_N)

    def ppo_streams(tr, U, B):
        reach = tr.vec.cenv.reachable
        return (reach[torch.randint(0, len(reach), (U, B), generator=g, device=dev)]
                .to(torch.int32),
                torch.randint(0, tr.A, (U, B), dtype=torch.int32, generator=g, device=dev),
                torch.log(torch.rand((U, B), generator=g, device=dev) * 0.5 + 0.1),
                torch.randn((U, B), generator=g, device=dev),
                10 * torch.randn((U, B), generator=g, device=dev))

    def check_b6(outs, ref):
        err = lc.check_b6(outs, ref)
        errs["ppo_optimize"] = max(errs["ppo_optimize"], err)
        return err

    def b6_case(tr, T):
        """The trainer, its ``[epochs · n_minibatches, N·T / n_minibatches]``
        streams and a fresh optimizer's flat params, μ, ν and count."""
        agent = tr.agent
        streams = ppo_streams(tr, agent.epochs * agent.n_minibatches,
                              tr.vec.n_envs * T // agent.n_minibatches)
        a0 = tr.init(seed=4, generator=g)[0]
        return [tr, streams, (ravel(a0.params), a0.mu, a0.nu, a0.count.reshape(1))]

    b6_absent, b6_absent_args = cli_trainer(PPO_STOCH_MAIN)
    b6_cases = {"island": b6_case(ppo_tr, PPO_T),
                "absent": b6_case(b6_absent, b6_absent_args.chunk_steps)}
    for alias, case in b6_cases.items():
        trn, streams, args = case
        for rnd in range(2):
            ce = torch.tensor([0.5 - 0.25 * rnd], device=dev)
            outs = pk.ppo_optimize(trn.agent, *args, ce, streams)
            again = pk.ppo_optimize(trn.agent, *args, ce, streams)
            torch.cuda.synchronize()
            if not lc.outputs_equal(outs, again):
                raise AssertionError(f"B6 {alias} round {rnd}: two launches differ")
            ref = pk.ppo_optimize_reference(trn.agent, *args, ce, streams)
            err = check_b6(outs, ref)
            log(f"B6 {alias} U={streams[0].shape[0]} B={streams[0].shape[1]} S={trn.S} round "
                f"{rnd}: two launches bitwise equal; params/μ/ν max |err| {err:.3g} "
                f"(rtol 2e-4), loss "
                f"{float(outs[4][0]):.6g} vs {float(ref[4][0]):.6g}, count {int(outs[3][0])}")
            args = ref[:4]
        case[2] = args
    errs["ppo_optimize"] = max(errs["ppo_optimize"], abl.check_b6_case("ragged", dev, g))

    # -- 3f. B11 against its plain version ---------------------------------------
    header("== 3f. fused actor-critic forward B11 vs plain, forward and gradients")
    mlp = fm.PallasActorCriticMLP(288, 4)
    mlp_params = {k: v.requires_grad_(True) for k, v in
                  mlp.init_params(torch.Generator().manual_seed(5), dev).items()}
    names = ("w1", "b1", "w2", "b2", "wh", "bh")

    def b11_inputs(B):
        return (torch.rand((B, 288), generator=g, device=dev) < 0.1).to(torch.float32)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for B in (1, 33, 100, 1024, 16384):
        geo = fm.geometry(B, n_sm)
        built = fm.kernel_geometry(B, n_sm)
        assert built == (geo.rows, geo.tiles, geo.grid, geo.smem_bytes), (B, geo, built)
        x = b11_inputs(B)
        out = fm.fused_mlp(x, *(mlp_params[k] for k in names))
        torch.cuda.synchronize()
        ref = fm.fused_mlp_reference(x, *(mlp_params[k] for k in names))[0]
        torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-5)
        grads = torch.autograd.grad((out ** 2).sum(), [mlp_params[k] for k in names])
        rgrads = torch.autograd.grad((ref ** 2).sum(), [mlp_params[k] for k in names])
        for a, b in zip(grads, rgrads):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
        err = float((out - ref).detach().abs().max())
        errs["fused_mlp"] = max(errs["fused_mlp"], err)
        log(f"B11 B={B:5d}: forward max |err| {err:.3g} (atol 1e-5); gradients within "
            f"rtol/atol 1e-3; {geo.tiles} tiles of {geo.rows} rows on {geo.grid} blocks "
            f"({geo.smem_bytes} B shared; mirror equal)")

    # -- 3g. B7 against its plain version ----------------------------------------
    header("== 3g. stochastic rollout kernel B7 vs plain (bitwise), N=4096, T=1024")
    stoch_envs = {}

    def stoch_env(alias, kw):
        key = (alias, tuple(sorted(kw.items())))
        if key not in stoch_envs:
            stoch_envs[key] = make_env(alias, compiled=True, device=dev, **kw)
        return stoch_envs[key]

    for alias, kw in B7_CASES:
        seng = srk.StochRolloutEngine(stoch_env(alias, kw), N_FULL)
        place = srk.placement(seng.tables)
        for start in ("reset", "mid-episode"):
            state = seng.reset(g) if start == "reset" else mid_episode(seng.cenv, N_FULL)
            streams = seng.draw_streams(g, 1024)
            outs = seng.run_streams(state, *streams)
            torch.cuda.synchronize()
            assert_equal(outs, srk.stoch_rollout_reference(seng.tables, state, *streams),
                         f"B7 {alias} {kw} {start}")
            log(f"B7 {alias:9s} {str(kw):13s} mode {seng.tables.mode} tables in {place:6s} "
                f"from {start:11s}: 8 outputs equal, {int(outs[6].sum())} episodes")

    # -- 3h. B8 against its plain version ----------------------------------------
    header("== 3h. stochastic fused tabular-Q kernel B8 vs plain")

    def stoch_trainer(alias, n, kw=None):
        cenv = stoch_env(alias, kw or {})
        agent = TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=40_000)
        return FusedTabularQTrainer(agent, VecEnv(cenv, n))

    def check_b8(tr, q, state, step0, T, label):
        # B8 sums its TD errors in fixed point, exactly in any order, so it is
        # held bitwise, inside the reference's tolerance (Q to atol 1e-4).
        n = tr.vec.n_envs
        rand_a = torch.randint(0, tr.A, (T, n), dtype=torch.int32, generator=g, device=dev)
        u = torch.rand((T, n), generator=g, device=dev)
        streams = (rand_a, u) + tr.vec.draw_mechanics(g, T)
        outs = tsk.tabq_stoch(tr.tables, tr.hyper, q, state, step0, *streams)
        torch.cuda.synchronize()
        ref = tsk.tabq_stoch_reference(tr.tables, tr.hyper, q, state, step0, *streams)
        err = float((outs[0] - ref[0]).abs().max())
        assert_equal(outs, ref, f"B8 {label}")
        errs["tabq_stoch"] = max(errs["tabq_stoch"], err)
        log(f"B8 {label}: 11 outputs equal (Q max |err| {err:.3g}); "
            f"{int(outs[7].sum())} episodes")

    step0 = torch.tensor([1_000], dtype=torch.int64, device=dev)
    for alias in ("absent", "whisky", "tomato"):
        tr = stoch_trainer(alias, N_FULL)
        check_b8(tr, torch.randn(tr.S, tr.A, generator=g, device=dev),
                 mid_episode(tr.vec.cenv, N_FULL), step0, 1,
                 f"(a) {alias} N=4096 T=1 random Q, random lanes")
    for alias, kw in (("absent", {}), ("whisky", {}), ("tomato", {}), ("friend", {"cap": 15})):
        tr = stoch_trainer(alias, N_FULL, kw)
        check_b8(tr, torch.zeros(tr.S, tr.A, device=dev), tr.init(g)[1], step0, 256,
                 f"(b) {alias} {kw} N=4096 T=256 zero Q from reset, tables in "
                 f"{srk.placement(tr.tables, tsk.smem_bytes(tr.S, tr.A))}")
    for alias in STOCH_MAIN:
        tr = stoch_trainer(alias, 64)
        check_b8(tr, torch.zeros(tr.S, tr.A, device=dev), tr.init(g)[1],
                 torch.zeros(1, dtype=torch.int64, device=dev), 128,
                 f"(c) {alias} N=64 T=128 zero Q (the CLI commands' chunk), streams staged in "
                 f"tiles of {tsk.kernel_tile_steps(tr.tables, 64, 128)} steps")
    # (d) Hot cells: every lane on tomato's reset state, late in the ε anneal.
    hot = list(lc.tabq_stoch_case("tomato wide", dev, g, hot=True))
    hot[5:] = [x[:256] for x in hot[5:]]
    outs = tsk.tabq_stoch(*hot)
    torch.cuda.synchronize()
    assert_equal(outs, tsk.tabq_stoch_reference(*hot), "B8 (d) hot cells")
    log(f"B8 (d) tomato N=4096 T=256 every lane on state {int(hot[3][0][0, 0])}, ε "
        f"annealed to step {int(hot[4][0])}: 11 outputs equal; {int(outs[7].sum())} episodes")
    del hot, outs

    # -- 3i. B9 against its plain version ----------------------------------------
    header("== 3i. stochastic DQN collect kernel B9 vs plain (bitwise), N=4096, T=1024")

    def stoch_dqn_trainer(cenv, n):
        agent = DQNAgent(cenv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                         replay_capacity=50_000, sync_every=100)
        return FusedDQNTrainer(agent, VecEnv(cenv, n), updates_per_chunk=32)

    step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
    for alias, kw in B7_CASES:
        tr = stoch_dqn_trainer(stoch_env(alias, kw), N_FULL)
        place = srk.placement(tr.tables, tr.S)
        greedy = torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g, device=dev)
        for start in ("reset", "mid-episode"):
            state = tr.init(generator=g)[1] if start == "reset" else mid_episode(tr.vec.cenv,
                                                                                 N_FULL)
            rand_a = torch.randint(0, tr.A, (1024, N_FULL), dtype=torch.int32, generator=g,
                                   device=dev)
            u = torch.rand((1024, N_FULL), generator=g, device=dev)
            streams = (rand_a, u) + tr.vec.draw_mechanics(g, 1024)
            hypers = ((tr.hyper, "annealing"),) + (
                ((tr.hyper.warmup(), "pinned to 1"),) if start == "reset" else ())
            for hyper, eps in hypers:
                outs = dsk.dqn_stoch_collect(tr.tables, hyper, greedy, state, step0, *streams)
                torch.cuda.synchronize()
                assert_equal(outs, dsk.dqn_stoch_collect_reference(
                    tr.tables, hyper, greedy, state, step0, *streams),
                    f"B9 {alias} {kw} {start} ε {eps}")
                log(f"B9 {alias:9s} {str(kw):13s} mode {tr.tables.mode} tables in {place:6s} "
                    f"from {start:11s} ε {eps:11s}: 16 outputs equal, "
                    f"{int(outs[6].sum())} episodes")

    # -- 3j. B10 against its plain version ---------------------------------------
    header("== 3j. stochastic PPO collect kernel B10 vs plain (bitwise), N=4096, T=1024")

    def stoch_ppo_trainer(cenv, n):
        agent = PPOAgent(cenv, net="table", lr=1e-3, entropy_bonus=0.05)
        return FusedPPOTrainer(agent, VecEnv(cenv, n))

    for alias, kw in B7_CASES:
        tr = stoch_ppo_trainer(stoch_env(alias, kw), N_FULL)
        place = srk.placement(tr.tables, psk.smem_bytes(tr.S, tr.A))
        astate, vstate = tr.init(seed=3, generator=g)
        rows = tr.policy_rows(astate.params)
        for start in ("reset", "mid-episode"):
            state = vec_tuple(vstate) if start == "reset" else mid_episode(tr.vec.cenv, N_FULL)
            streams = (torch.rand((1024, N_FULL), generator=g, device=dev),) + \
                tr.vec.draw_mechanics(g, 1024)
            outs = psk.ppo_stoch_collect(tr.tables, rows, state, *streams)
            torch.cuda.synchronize()
            assert_equal(outs, psk.ppo_stoch_collect_reference(tr.tables, rows, state, *streams),
                         f"B10 {alias} {kw} {start}")
            log(f"B10 {alias:9s} {str(kw):13s} mode {tr.tables.mode} rows and tables in "
                f"{place:6s} from {start:11s}: 18 outputs equal, {int(outs[5].sum())} "
                f"episodes, actions used "
                f"{torch.bincount(outs[11].reshape(-1), minlength=tr.A).tolist()}")
    b10_args = lc.ppo_stoch_case("absent main", dev, g)
    outs = psk.ppo_stoch_collect(*b10_args)
    torch.cuda.synchronize()
    assert_equal(outs, psk.ppo_stoch_collect_reference(*b10_args), "B10 absent N=1024 T=32")
    assert psk.kernel_tile_bytes() == psk.TILE_BYTES, psk.kernel_tile_bytes()
    log(f"B10 absent N=1024 T=32 (the command's chunk) from reset: 18 outputs equal, "
        f"{int(outs[5].sum())} episodes; tile bytes mirror {psk.TILE_BYTES} equals the kernel's")
    del b10_args, outs

    # -- 3k. the grid-wide routes against their plain versions ----------------
    header("== 3k. grid-wide routes vs plain: B4 grid (sokoban MLP at hidden 512, B=128; "
           "width 128 at B=4096; ragged; double-Q with a sync), B6 wide (island at hidden "
           "256; ragged; 8 actions; hidden 1813), each launched twice")
    for name in abl.B4_GRID_CHECKS:
        errs["dqn_update_grid"] = max(errs["dqn_update_grid"], abl.check_b4_case(name, dev, g))
    for name in abl.B6_WIDE_CHECKS:
        errs["ppo_wide"] = max(errs["ppo_wide"], abl.check_b6_case(name, dev, g))

    # -- 4. the main path -------------------------------------------------------
    header("== 4. main path: rollout engine at 4096 lanes, the shift preset, the sokoban "
           "DQN command, the island PPO preset, the fused-forward PPO net, the stochastic "
           "tabular-q commands, the stochastic rollout engine at 4096 lanes, the whisky "
           "DQN and absent PPO commands")
    all_counts = {"rollout": rk.counts, "tabq": tk.counts, "dqn_collect": dk.counts,
                  "dqn_update": duk.counts, "dqn_update_grid": duk.grid_counts,
                  "ppo_collect": pck.counts, "ppo_optimize": pk.counts,
                  "ppo_wide": pk.wide_counts, "fused_mlp": fm.counts,
                  "stoch_rollout": srk.counts, "tabq_stoch": tsk.counts,
                  "dqn_stoch_collect": dsk.counts, "ppo_stoch_collect": psk.counts}
    for c in all_counts.values():
        c.reset()
    eng = rk.RolloutEngine(make_env("shift", compiled=True), N_FULL)
    gen = torch.Generator(device=eng.device).manual_seed(0)
    state, totals = eng.reset(), []
    for _ in range(4):
        state, acc = eng.run_random_reduced(state, gen, 4096)
        totals.append(acc)
    stats = run(["shift", "tabular-q", "--compiled", "--mxu", "--fused-kernel", "--preset"])
    t_dqn = time.perf_counter()
    dqn_stats = run(DQN_MAIN)
    t_dqn = time.perf_counter() - t_dqn
    t_ppo = time.perf_counter()
    ppo_stats = run(PPO_MAIN)
    t_ppo = time.perf_counter() - t_ppo
    island = make_env("island", compiled=True, device=dev)
    pallas_tr = MXUPPOTrainer(PPOAgent(island, net="pallas", lr=5e-4, entropy_bonus=0.5),
                              VecEnv(island, PPO_N))
    pa, pv = pallas_tr.init(seed=0)
    pallas_losses = []
    for _ in range(3):
        pa, pv, _, loss = pallas_tr.train_chunk(pa, pv, gen, PPO_T)
        pallas_losses.append(float(loss))
    stoch_stats, stoch_wall = {}, {}
    for alias, (flags, _) in STOCH_MAIN.items():
        t_cli = time.perf_counter()
        stoch_stats[alias] = run([alias] + STOCH_TAB + flags)
        stoch_wall[alias] = time.perf_counter() - t_cli
    engine_totals = {}
    for alias in ("absent", "whisky", "tomato", "friend"):
        seng = srk.StochRolloutEngine(make_env(alias, compiled=True), N_FULL)
        sgen = torch.Generator(device=seng.device).manual_seed(0)
        sstate, acc = seng.run_random_reduced(seng.reset(sgen), sgen, 4096)
        assert all(x.shape == (1, N_FULL) for x in sstate)
        assert all(bool(torch.isfinite(x.float()).all()) for x in sstate)
        engine_totals[alias] = {k: float(v) for k, v in acc.items()}
        engine_totals[alias]["bound"] = 100.0 * float(seng.cenv.reward_table.abs().max())
    t_dqn_stoch = time.perf_counter()
    dqn_stoch_stats = run(DQN_STOCH_MAIN)
    t_dqn_stoch = time.perf_counter() - t_dqn_stoch
    t_ppo_stoch = time.perf_counter()
    ppo_stoch_stats = run(PPO_STOCH_MAIN)
    t_ppo_stoch = time.perf_counter() - t_ppo_stoch
    wide_stats, wide_wall = {}, {}
    for name, argv in (("island ppo-mlp --n-hidden 256", PPO_WIDE_MAIN),
                       *((f"sokoban deep-q {k}", v) for k, v in DQN_WIDE_MAIN.items())):
        t_cli = time.perf_counter()
        wide_stats[name] = run(argv)
        wide_wall[name] = time.perf_counter() - t_cli
    launches = {k: c.launches for k, c in all_counts.items()}
    plain = {k: c.plain_calls for k, c in all_counts.items()}
    log(f"launches {launches}, plain-version calls {plain}")
    assert launches["rollout"] == 4 and all(v > 0 for v in launches.values()), launches
    assert launches["ppo_collect"] == 2 * 76, launches  # the island preset, at both widths
    assert launches["ppo_optimize"] == 76 + PPO_STOCH_CHUNKS, launches
    assert launches["ppo_wide"] == 76, launches
    assert launches["dqn_update"] == 24 + DQN_STOCH_CHUNKS, launches
    assert launches["dqn_update_grid"] == 2 * DQN_WIDE_CHUNKS, launches
    assert launches["fused_mlp"] == 3 * (PPO_T + 1 + 16), launches
    assert launches["stoch_rollout"] == 4, launches
    assert launches["tabq_stoch"] == STOCH_CHUNKS, launches
    assert launches["dqn_stoch_collect"] == DQN_STOCH_CHUNKS + 1, launches
    assert launches["ppo_stoch_collect"] == PPO_STOCH_CHUNKS, launches
    assert not any(plain.values()), plain
    episodes = sum(int(a["episodes"]) for a in totals)
    mean_ret = sum(float(a["finished_return_sum"]) for a in totals) / max(episodes, 1)
    assert all(x.shape == (1, N_FULL) for x in state)
    assert all(bool(torch.isfinite(x.float()).all()) for x in state)
    # A uniform random policy on shift: episodes end in lava, at the goal or
    # at the 100-step timeout, so the mean finished return lies in [-100, 49].
    assert episodes > 0 and -100.0 <= mean_ret <= 49.0, (episodes, mean_ret)
    log(f"rollout engine: {episodes} random-policy episodes, mean return {mean_ret:.3f}")
    log(f"CLI final eval: {stats}")
    assert stats["mean_return"] >= 38.0, stats  # shift optimum is 40
    log(f"DQN CLI ({t_dqn:.3f} s wall, warmup and evals included) final eval: "
        f"observed {dqn_stats['mean_return']}, hidden {dqn_stats['mean_hidden']}, "
        f"length {dqn_stats['mean_length']}")
    assert dqn_stats["mean_return"] >= 40.0, dqn_stats  # sokoban optimum 45 / 35
    log(f"PPO CLI ({t_ppo:.3f} s wall, evals included) final eval: observed "
        f"{ppo_stats['mean_return']}, hidden {ppo_stats['mean_hidden']}, length "
        f"{ppo_stats['mean_length']}")
    assert ppo_stats["mean_return"] >= 40.0 and ppo_stats["mean_hidden"] >= 40.0, ppo_stats
    log(f"PPOAgent(net='pallas') on the MXU PPO trainer, 3 chunks: losses {pallas_losses}")
    assert all(math.isfinite(x) for x in pallas_losses), pallas_losses
    for alias, (_, gate) in STOCH_MAIN.items():
        st = stoch_stats[alias]
        log(f"{alias} tabular-q CLI ({stoch_wall[alias]:.3f} s wall, evals included) final "
            f"eval: observed {st['mean_return']}, hidden {st['mean_hidden']}, length "
            f"{st['mean_length']}, episodes {st['episodes']}")
        assert gate(st), (alias, st)
    for alias, acc in engine_totals.items():
        mean = acc["finished_return_sum"] / max(acc["episodes"], 1.0)
        log(f"stochastic engine {alias}: {acc['episodes']:.0f} random-policy episodes, mean "
            f"return {mean:.3f}")
        # Every episode ends by the 100-step timeout, so its return is bounded
        # by 100 times the largest reward magnitude of the tables.
        assert acc["episodes"] > 0 and abs(mean) <= acc["bound"], (alias, acc)
    log(f"whisky deep-q CLI ({t_dqn_stoch:.3f} s wall, warmup and evals included) final "
        f"eval: observed {dqn_stoch_stats['mean_return']}, hidden "
        f"{dqn_stoch_stats['mean_hidden']}, length {dqn_stoch_stats['mean_length']}")
    assert dqn_stoch_stats["mean_return"] >= 25.0, dqn_stoch_stats  # it drinks: ≈36
    log(f"absent ppo-mlp CLI ({t_ppo_stoch:.3f} s wall, evals included) final eval: "
        f"observed {ppo_stoch_stats['mean_return']}, hidden {ppo_stoch_stats['mean_hidden']}, "
        f"length {ppo_stoch_stats['mean_length']}, episodes {ppo_stoch_stats['episodes']}")
    assert (ppo_stoch_stats["mean_return"] > 40.0 and ppo_stoch_stats["mean_hidden"]
            < ppo_stoch_stats["mean_return"] - 5.0), ppo_stoch_stats
    for name, st in wide_stats.items():
        log(f"{name} CLI ({wide_wall[name]:.3f} s wall, evals included) final eval: observed "
            f"{st['mean_return']}, hidden {st['mean_hidden']}, length {st['mean_length']}")
        assert all(st[k] is not None and math.isfinite(float(st[k]))
                   for k in ("mean_return", "mean_hidden")), st

    # -- 5. full width: rates, kernel times, plain times, bounds --------------
    header("== 5. timing: kernels, plain versions, bounds, trainer rates")
    results = {}
    S, A = eng.tables.shape
    T1 = 32768
    actions = torch.randint(0, A, (T1, N_FULL), dtype=torch.int32, generator=g, device=dev)
    st0 = eng.reset()
    rate1 = windows_per_s(lambda: eng.run_random_reduced(st0, gen, T1), T1 * N_FULL)
    k_ms, outs = timed(lambda: rk.rollout(eng.tables, st0, actions), 5)
    p_ms, ref = timed(lambda: rk.rollout_reference(eng.tables, st0, actions), 3, warmup=False)
    assert_equal(outs, ref, "B1 full width")
    log(f"B1 T={T1} vs plain: 8 outputs equal")
    nbytes = 4 * T1 * N_FULL + 5 * 4 * N_FULL + 8 * 4 * N_FULL + 13 * S * A
    b_ms, b_by = bound(nbytes, 6 * T1 * N_FULL)
    results["rollout"] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                              bound_ms=b_ms, bound_by=b_by, rate=rate1,
                              shapes={"actions": [T1, N_FULL], "tables": [S, A]})
    log(f"B1 T={T1}: {rate1:.6g} env-steps/s (run_random_reduced, median of 5); "
        f"kernel {k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")

    T2 = 8192
    tr = trainer(N_FULL)
    a0, v0 = tr.init()
    rate2 = windows_per_s(lambda: tr.train_chunk(a0, v0, gen, T2), T2 * N_FULL)
    rand_a = torch.randint(0, A, (T2, N_FULL), dtype=torch.int32, generator=g, device=dev)
    u = torch.rand((T2, N_FULL), generator=g, device=dev)
    step0 = a0.step.reshape(1)
    k_ms, outs = timed(lambda: tk.tabq(tr.tables, tr.hyper, a0.q, v0, step0, rand_a, u), 5)
    p_ms, ref = timed(lambda: tk.tabq_reference(tr.tables, tr.hyper, a0.q, v0, step0, rand_a, u),
                      3, warmup=False)
    torch.testing.assert_close(outs[0], ref[0], rtol=0.0, atol=1e-4)
    assert_equal(outs[1:], ref[1:], "B2 full width")
    err = float((outs[0] - ref[0]).abs().max())
    errs["tabq"] = max(errs["tabq"], err)
    log(f"B2 T={T2} vs plain: Q max |err| {err:.3g} (atol 1e-4); integer outputs equal")
    nbytes = 8 * T2 * N_FULL + 2 * 4 * S * A + 5 * 4 * N_FULL + 9 * 4 * N_FULL + 8 * 2 + 13 * S * A
    b_ms, b_by = bound(nbytes, 20 * T2 * N_FULL)
    results["tabq"] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                           bound_ms=b_ms, bound_by=b_by, rate=rate2,
                           shapes={"rand_a": [T2, N_FULL], "u": [T2, N_FULL], "q": [S, A]})
    log(f"B2 T={T2}: {rate2:.6g} env-steps/s (train_chunk, median of 5); "
        f"kernel {k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    # The CLI preset's own chunk: N=64, T=128.
    a64, v64 = tr64.init()
    call = (tr64.tables, tr64.hyper, a64.q, v64, a64.step.reshape(1),
            torch.randint(0, A, (128, 64), dtype=torch.int32, generator=g, device=dev),
            torch.rand((128, 64), generator=g, device=dev))
    k_ms, outs = timed(lambda: tk.tabq(*call), 20)
    p_ms, ref = timed(lambda: tk.tabq_reference(*call), 3)
    torch.testing.assert_close(outs[0], ref[0], rtol=0.0, atol=1e-4)
    assert_equal(outs[1:], ref[1:], "B2 CLI shape")
    nbytes = 8 * 128 * 64 + 2 * 4 * S * A + 5 * 4 * 64 + 9 * 4 * 64 + 8 * 2 + 13 * S * A
    b_ms, b_by = bound(nbytes, 20 * 128 * 64)
    d_ms = device_ms(lambda: tk.tabq(*call))
    results["tabq"]["cases"] = {"cli": dict(
        ms=statistics.median(k_ms), device_ms=d_ms, plain_ms=statistics.median(p_ms),
        bound_ms=b_ms, bound_by=b_by, shapes={"rand_a": [128, 64], "u": [128, 64],
                                              "q": [S, A]})}
    log(f"B2 CLI shape N=64 T=128 vs plain: Q within atol 1e-4, integer outputs equal; kernel "
        f"{k_ms} ms (device {d_ms:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    def b3_bound(S, A, T, n):
        nbytes = (8 * T * n + 4 * S + 13 * S * A + 20 * n + 8       # in
                  + 24 * T * n + 20 * n + 16 * n + 8)               # out
        return bound(nbytes, 12 * T * n)

    def b4_bound(S, D, H1, H2, A, U, B, double_q):
        P = D * H1 + H1 + H1 * H2 + H2 + H2 * A + A
        nbytes = 4 * S * D + 2 * 4 * 4 * P + U * B * 17 + 2 * 8 * 3 + 4
        fwd = 2 * B * (D * H1 + H1 * H2 + H2 * A)
        bwd = 2 * B * (2 * H1 * H2 + D * H1 + H2) + B * H2
        ops = U * ((3 if double_q else 2) * fwd + bwd + 10 * P)
        return bound(nbytes, ops)

    tr = dqn_trainer(128)
    d_state, d_v = tr.init()
    d_state, d_v, _ = tr.warmup_chunk(d_state, d_v, gen, 64)
    for n, T, label in ((128, 32, "main"), (N_FULL, 4096, "wide")):
        trn = tr if n == 128 else dqn_trainer(n)
        state = trn.init()[1]
        greedy = trn.greedy_row(d_state.params)
        rand_a = torch.randint(0, trn.A, (T, n), dtype=torch.int32, generator=g, device=dev)
        u = torch.rand((T, n), generator=g, device=dev)
        step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
        call = (trn.tables, trn.hyper, greedy, state, step0, rand_a, u)
        k_ms, outs = timed(lambda: dk.dqn_collect(*call), 20 if label == "main" else 5)
        p_ms, ref = timed(lambda: dk.dqn_collect_reference(*call), 3, warmup=label == "main")
        assert_equal(outs, ref, f"B3 {label}")
        b_ms, b_by = b3_bound(trn.S, trn.A, T, n)
        key = "dqn_collect" if label == "main" else "dqn_collect_wide"
        results[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                            bound_ms=b_ms, bound_by=b_by,
                            shapes={"rand_a": [T, n], "u": [T, n], "greedy": [trn.S]})
        if label == "main":
            results[key]["device_ms"] = device_ms(lambda: dk.dqn_collect(*call))
        log(f"B3 {label} N={n} T={T} vs plain: 16 outputs equal; kernel {k_ms} ms "
            f"(device {results[key].get('device_ms', 'not profiled')}); plain {p_ms} ms; "
            f"bound {b_ms:.6g} ms ({b_by})")

    w_state, w_v = b4_whisky.init(generator=g)
    w_state = b4_whisky.warmup_chunk(w_state, w_v, gen, 64)[0]
    b4 = {}
    for trn, st, U, B, label in ((tr, d_state, 32, 128, "sokoban"),
                                 (tr, d_state, 256, 512, "wide"),
                                 (b4_whisky, w_state, b4_whisky.updates_per_chunk,
                                  b4_whisky.agent.batch_size, "whisky")):
        D, (H1, H2), A = trn.agent.obs_flat.shape[1], trn.agent.hidden, trn.A
        idxs = torch.randint(0, st.buffer.size, (U, B), generator=g, device=dev)
        batch = map_fields(lambda x: x[idxs], st.buffer.storage)
        call = (trn.agent, st.params, st.target_params, st.mu, st.nu,
                st.count.reshape(1), st.updates.reshape(1), batch)
        k_ms = cuda_ms(lambda: duk.dqn_update(*call), 3 if label == "wide" else 10)
        p_ms = cuda_ms(lambda: duk.dqn_update_reference(*call), 3)
        err = lc.check_b4(duk.dqn_update(*call), duk.dqn_update_reference(*call))
        errs["dqn_update"] = max(errs["dqn_update"], err)
        b_ms, b_by = b4_bound(trn.S, D, H1, H2, A, U, B, trn.agent.double_q)
        b4[label] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         bound_ms=b_ms, bound_by=b_by,
                         shapes={"batch": [U, B], "hidden": [H1, H2], "obs": [trn.S, D]})
        log(f"B4 {label} U={U} B={B} S={trn.S} D={D} table={trn.agent.table} vs plain: max "
            f"|err| {err:.3g}; kernel {k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    results["dqn_update"] = dict(b4["sokoban"], cases={k: b4[k] for k in ("sokoban", "whisky")})
    results["dqn_update_wide"] = b4["wide"]
    # The grid route at its commands' shapes, U=32.
    def b4_grid_bound(S, D, H1, H2, A, U, B, double_q):
        P = D * H1 + H1 + H1 * H2 + H2 + H2 * A + A
        nbytes = 4 * S * D + 2 * 4 * 4 * P + U * B * 17 + 2 * 8 * 3 + 4
        passes = 3 if double_q else 2
        mma = U * 2 * B * (passes * (D * H1 + H1 * H2) + H1 * H2 + (H1 + 1) * H2
                           + (H2 + 1) * A + (D + 1) * H1)
        fp32 = U * (2 * passes * B * H2 * A + B * H2 + 10 * P)
        return bound_3xtf32(nbytes, mma, fp32)

    b4g = {}
    for name in ("hidden512", "batch4096"):
        agent, args = lc.dqn_case(name, dev, g)
        S, D = agent.obs_flat.shape
        (H1, H2), A, (U, B) = agent.hidden, agent.env.n_actions, args[-1].action.shape
        assert duk.route(D, H1, H2, A, B) == "grid"
        k_ms = cuda_ms(lambda: duk.dqn_update(agent, *args), 5)
        p_ms = cuda_ms(lambda: duk.dqn_update_reference(agent, *args), 3)
        err = lc.check_b4(duk.dqn_update(agent, *args), duk.dqn_update_reference(agent, *args))
        errs["dqn_update_grid"] = max(errs["dqn_update_grid"], err)
        b_ms, b_by = b4_grid_bound(S, D, H1, H2, A, U, B, agent.double_q)
        fp32_ms, fp32_by = b4_bound(S, D, H1, H2, A, U, B, agent.double_q)
        b4g[name] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=fp32_ms,
                         bound_fp32_by=fp32_by,
                         device_ms=device_ms(lambda: duk.dqn_update(agent, *args)),
                         shapes={"batch": [U, B], "hidden": [H1, H2], "obs": [S, D]})
        log(f"B4 grid {name} U={U} B={B} hidden {H1}x{H2} vs plain: max |err| {err:.3g}; "
            f"kernel {k_ms} ms (device {b4g[name]['device_ms']:.6g} ms); plain {p_ms} ms; "
            f"bound {b_ms:.6g} ms ({b_by}, 3xTF32 at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; "
            f"float32 {fp32_ms:.6g} ms, {fp32_by})")
        del args
    results["dqn_update_grid"] = dict(b4g["hidden512"], cases=b4g)

    chunks = 8
    state_box = [d_state, d_v]

    def dqn_window():
        a, v = state_box
        for _ in range(chunks):
            a, v, _, loss = tr.train_chunk(a, v, gen, 32)
        state_box[:] = [a, v]
        return loss

    dqn_window()  # warm-up window
    rate3 = windows_per_s(dqn_window, chunks * 32 * 128)
    results["dqn_collect"]["rate"] = rate3
    results["dqn_update"]["rate"] = rate3
    log(f"fused DQN trainer N=128, T=32, U=32: {rate3:.6g} env-steps/s "
        f"(train_chunk, {chunks} chunks per window, median of 5)")
    def b5_bound(S, A, T, n):
        nbytes = (4 * T * n + 13 * S * A + 4 * S * 2 * A + 20 * n    # in
                  + 36 * T * n + 20 * n + 16 * n)                     # out
        return bound(nbytes, (A + 12) * T * n)

    for alias, n, T, label in (("island", PPO_N, PPO_T, "main"),
                               ("sokoban", N_FULL, 1024, "wide")):
        trn = ppo_tr if label == "main" else ppo_trainer(alias, n)
        astate, vstate = trn.init(seed=3)
        call = (trn.tables, trn.policy_rows(astate.params), vec_tuple(vstate),
                torch.rand((T, n), generator=g, device=dev))
        k_ms, outs = timed(lambda: pck.ppo_collect(*call), 20 if label == "main" else 5)
        p_ms, ref = timed(lambda: pck.ppo_collect_reference(*call), 3, warmup=label == "main")
        assert_equal(outs, ref, f"B5 {label}")
        b_ms, b_by = b5_bound(trn.S, trn.A, T, n)
        key = "ppo_collect" if label == "main" else "ppo_collect_wide"
        results[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                            bound_ms=b_ms, bound_by=b_by,
                            shapes={"u": [T, n], "tables": [trn.S, trn.A]})
        results[key]["device_ms"] = device_ms(lambda: pck.ppo_collect(*call))
        log(f"B5 {label} {alias} N={n} T={T} vs plain: 18 outputs equal; kernel {k_ms} ms "
            f"(device {results[key]['device_ms']:.6g}); plain {p_ms} ms; "
            f"bound {b_ms:.6g} ms ({b_by})")

    b6 = {}
    for alias, (trn, streams, args) in b6_cases.items():
        agent = trn.agent
        S, D = agent.obs_flat.shape
        H1, H2 = agent.hidden
        A1 = trn.A + 1
        P = args[0].numel()
        U, B = streams[0].shape
        ce = torch.tensor([0.25], device=dev)
        call = (agent, *args, ce, streams)
        k_ms = cuda_ms(lambda: pk.ppo_optimize(*call), 10)
        p_ms = cuda_ms(lambda: pk.ppo_optimize_reference(*call), 3)
        check_b6(pk.ppo_optimize(*call), pk.ppo_optimize_reference(*call))
        per_row = 6 * H1 * H2 + 6 * H2 * A1 + 4 * (H1 + H2) + 20 * A1
        b_ms, b_by = bound(4 * S * D + 6 * 4 * P + 20 * U * B + 8 * 2 + 4 * 2,
                           U * (B * per_row + 4 * S * D * H1 + 12 * P))
        b6[alias] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         bound_ms=b_ms, bound_by=b_by,
                         shapes={"streams": [U, B], "hidden": [H1, H2], "obs": [S, D],
                                 "params": P})
        log(f"B6 {alias} U={U} B={B} vs plain: within tolerance; kernel {k_ms} ms; plain "
            f"{p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    results["ppo_optimize"] = dict(b6["island"], cases=b6)
    # The wide route at its command's shape: island at hidden 256. Its
    # products (the three B × H × H ones, the fold and w1's gradient through
    # it) run in 3xTF32 on the tensor cores; beside it the float32 bound.
    agent, args = lc.ppo_case("island256", dev, g)
    S, D = agent.obs_flat.shape
    H1, H2 = agent.hidden
    A1, P, (U, B) = agent.env.n_actions + 1, args[0].numel(), args[-1][0].shape
    assert pk.route(S, D, H1, H2, A1 - 1) == "wide"
    k_ms = cuda_ms(lambda: pk.ppo_optimize(agent, *args), 5)
    p_ms = cuda_ms(lambda: pk.ppo_optimize_reference(agent, *args), 3)
    errs["ppo_wide"] = max(errs["ppo_wide"], lc.check_b6(
        pk.ppo_optimize(agent, *args), pk.ppo_optimize_reference(agent, *args)))
    nbytes = 4 * S * D + 6 * 4 * P + 20 * U * B + 8 * 2 + 4 * 2
    per_row = 6 * H2 * A1 + 4 * (H1 + H2) + 20 * A1
    b_ms, b_by = bound_3xtf32(nbytes, U * (6 * B * H1 * H2 + 4 * S * D * H1),
                              U * (B * per_row + 12 * P))
    fp32_ms, fp32_by = bound(nbytes, U * (B * (6 * H1 * H2 + per_row) + 4 * S * D * H1
                                          + 12 * P))
    results["ppo_wide"] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                               bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=fp32_ms,
                               bound_fp32_by=fp32_by,
                               device_ms=device_ms(lambda: pk.ppo_optimize(agent, *args)),
                               shapes={"streams": [U, B], "hidden": [H1, H2], "obs": [S, D],
                                       "params": P})
    log(f"B6 wide island hidden {H1}x{H2} U={U} B={B} vs plain: within tolerance; kernel "
        f"{k_ms} ms (device {results['ppo_wide']['device_ms']:.6g} ms); plain {p_ms} ms; "
        f"bound {b_ms:.6g} ms ({b_by}, 3xTF32; float32 {fp32_ms:.6g} ms, {fp32_by})")
    del args

    w = [mlp_params[k].detach() for k in names]
    for B, label in ((1024, "main"), (16384, "wide")):
        x = b11_inputs(B)
        k_ms = cuda_ms(lambda: fm.fused_mlp_forward(x, *w), 20)
        p_ms = cuda_ms(lambda: fm.fused_mlp_reference(x, *w), 20)
        got, ref = fm.fused_mlp_forward(x, *w)[0], fm.fused_mlp_reference(x, *w)[0]
        torch.testing.assert_close(got, ref, rtol=0.0, atol=1e-5)
        errs["fused_mlp"] = max(errs["fused_mlp"], float((got - ref).abs().max()))
        # The kernel reads x, the first 288 rows of w1 (not its padding to
        # 384), the other weights and biases, and writes out, h1 and h2.
        nbytes = 4 * (B * 288 + w[0][:288].numel() + sum(t.numel() for t in w[1:])
                      + 3 * B * 128)
        flops = 2 * B * (288 * 128 + 2 * 128 * 128)
        # The kernel's work: three TF32 tensor-core products per product
        # (3xTF32) at the TF32 rate; beside it the float32 bound of the
        # first design's CUDA-core work.
        fp32_ms, fp32_by = bound(nbytes, flops)
        b_ms, b_by = bound(nbytes, 3 * flops, TF32_OPS_PER_S)
        key = "fused_mlp" if label == "main" else "fused_mlp_wide"
        results[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                            bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=fp32_ms,
                            bound_fp32_by=fp32_by, shapes={"x": [B, 288]})
        results[key]["device_ms"] = device_ms(lambda: fm.fused_mlp_forward(x, *w))
        log(f"B11 {label} B={B} vs plain: within atol 1e-5; kernel {k_ms} ms (device "
            f"{results[key]['device_ms']:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms "
            f"({b_by}, 3xTF32 at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; float32 "
            f"{fp32_ms:.6g} ms, {fp32_by})")

    ppo_box = list(ppo_tr.init(seed=1))
    ppo_chunks = 4

    def ppo_window():
        a, v = ppo_box
        for _ in range(ppo_chunks):
            a, v, _, loss = ppo_tr.train_chunk(a, v, gen, PPO_T)
        ppo_box[:] = [a, v]
        return loss

    ppo_window()  # warm-up window
    rate4 = windows_per_s(ppo_window, ppo_chunks * PPO_T * PPO_N)
    results["ppo_collect"]["rate"] = rate4
    results["ppo_optimize"]["rate"] = rate4
    log(f"fused PPO trainer N={PPO_N}, T={PPO_T}, 16 updates of {PPO_N * PPO_T // 4}: "
        f"{rate4:.6g} env-steps/s (train_chunk, {ppo_chunks} chunks per window, median of 5)")
    pallas_box = [pa, pv]

    def pallas_window():
        a, v, _, loss = pallas_tr.train_chunk(*pallas_box, gen, PPO_T)
        pallas_box[:] = [a, v]
        return loss

    pallas_window()
    rate5 = windows_per_s(pallas_window, PPO_T * PPO_N)
    results["fused_mlp"]["rate"] = rate5
    log(f"MXU PPO trainer with the fused-forward net N={PPO_N}, T={PPO_T}: {rate5:.6g} "
        "env-steps/s (train_chunk, one chunk per window, median of 5)")
    def b7_bound(tables, T, n):
        # Streams read: actions, plus bits (coin or drying), plus stumble and
        # rand_a (noise); the kernel skips the others.
        per_step = (4 + (4 if tables.mode or tables.dry_nbits else 0)
                    + (8 if tables.noise else 0))
        nbytes = per_step * T * n + 20 * n + 32 * n + srk.table_bytes(tables)
        return bound(nbytes, 10 * T * n)

    T7 = 32768
    b7 = {}
    for alias, kw in (("absent", {}), ("whisky", {}), ("tomato", {}), ("friend", {"cap": 127})):
        seng = srk.StochRolloutEngine(stoch_env(alias, kw), N_FULL)
        st0 = seng.reset(gen)
        rate = windows_per_s(lambda: seng.run_random_reduced(st0, gen, T7), T7 * N_FULL)
        streams = seng.draw_streams(g, T7)
        k_ms, outs = timed(lambda: srk.stoch_rollout(seng.tables, st0, *streams), 5)
        p_ms, ref = timed(lambda: srk.stoch_rollout_reference(seng.tables, st0, *streams), 1,
                          warmup=False)
        assert_equal(outs, ref, f"B7 {alias} full width")
        b_ms, b_by = b7_bound(seng.tables, T7, N_FULL)
        place = srk.placement(seng.tables)
        b7[alias] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         bound_ms=b_ms, bound_by=b_by, rate=rate, placement=place,
                         shapes={"streams": [T7, N_FULL], "tables": list(seng.tables.shape)})
        log(f"B7 {alias} {kw} T={T7} (tables in {place}) vs plain: 8 outputs equal; "
            f"{rate:.6g} env-steps/s (run_random_reduced, median of 5); kernel {k_ms} ms; "
            f"plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        del streams, outs, ref
    results["stoch_rollout"] = dict(b7["absent"], cases=b7)

    def b8_bound(tables, T, n):
        # Streams read: rand_a and u, plus bits and/or stumble and rand2.
        S, A = tables.shape
        per_step = (8 + (4 if tables.mode or tables.dry_nbits else 0)
                    + (8 if tables.noise else 0))
        nbytes = (per_step * T * n + 2 * 4 * S * A + 20 * n + 36 * n + 16
                  + srk.table_bytes(tables))
        return bound(nbytes, 24 * T * n)

    T8 = 8192
    b8 = {}
    # From zero Q as the trainer starts, and on tomato also from a random Q:
    # with zero Q and positive rewards the greedy policy parks every lane on
    # one (s, a) cell, whose shared-memory atomics then serialise.
    for alias, q_init in (("absent", "zero"), ("tomato", "zero"), ("tomato", "random")):
        tr = stoch_trainer(alias, N_FULL)
        a0, v0 = tr.init(gen)
        if q_init == "random":
            a0 = dataclasses.replace(a0, q=torch.randn(tr.S, tr.A, generator=g, device=dev))
        rate = windows_per_s(lambda: tr.train_chunk(a0, v0, gen, T8), T8 * N_FULL)
        rand_a = torch.randint(0, tr.A, (T8, N_FULL), dtype=torch.int32, generator=g,
                               device=dev)
        u = torch.rand((T8, N_FULL), generator=g, device=dev)
        call = (tr.tables, tr.hyper, a0.q, v0, a0.step.reshape(1), rand_a, u,
                *tr.vec.draw_mechanics(g, T8))
        k_ms, outs = timed(lambda: tsk.tabq_stoch(*call), 5)
        p_ms, ref = timed(lambda: tsk.tabq_stoch_reference(*call), 1, warmup=False)
        assert_equal(outs, ref, f"B8 {alias} {q_init} Q full width")
        err = float((outs[0] - ref[0]).abs().max())
        errs["tabq_stoch"] = max(errs["tabq_stoch"], err)
        b_ms, b_by = b8_bound(tr.tables, T8, N_FULL)
        key = alias if q_init == "zero" else f"{alias}_random_q"
        b8[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                       bound_ms=b_ms, bound_by=b_by, rate=rate,
                       shapes={"streams": [T8, N_FULL], "q": [tr.S, tr.A]})
        log(f"B8 {alias} {q_init} Q T={T8} vs plain: 11 outputs equal; trainer "
            f"{rate:.6g} env-steps/s (train_chunk, median of 5); kernel {k_ms} ms; plain "
            f"{p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        del call, outs, ref
    # The CLI commands' own chunk: N=64, T=128 (from zero Q).
    for alias in STOCH_MAIN:
        tr = stoch_trainer(alias, 64)
        a0, v0 = tr.init(gen)
        call = (tr.tables, tr.hyper, a0.q, v0, a0.step.reshape(1),
                torch.randint(0, tr.A, (128, 64), dtype=torch.int32, generator=g, device=dev),
                torch.rand((128, 64), generator=g, device=dev),
                *tr.vec.draw_mechanics(g, 128))
        k_ms, outs = timed(lambda: tsk.tabq_stoch(*call), 20)
        p_ms, ref = timed(lambda: tsk.tabq_stoch_reference(*call), 3)
        assert_equal(outs, ref, f"B8 {alias} CLI shape")
        b_ms, b_by = b8_bound(tr.tables, 128, 64)
        d_ms = device_ms(lambda: tsk.tabq_stoch(*call))
        b8[f"{alias}_cli"] = dict(ms=statistics.median(k_ms), device_ms=d_ms,
                                  plain_ms=statistics.median(p_ms), bound_ms=b_ms,
                                  bound_by=b_by, shapes={"streams": [128, 64],
                                                         "q": [tr.S, tr.A]})
        log(f"B8 {alias} CLI shape N=64 T=128 vs plain: 11 outputs equal; kernel {k_ms} ms "
            f"(device {d_ms:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        del call, outs, ref
    results["tabq_stoch"] = dict(b8["absent"], cases=b8)

    def b9_bound(tables, T, n):
        # Streams read: rand_a and u, plus bits (coin or drying) and/or stumble
        # and rand2 (noise); six records written; tables, greedy row, lanes.
        S, A = tables.shape
        per_step = (8 + (4 if tables.mode or tables.dry_nbits else 0)
                    + (8 if tables.noise else 0) + 24)
        nbytes = (per_step * T * n + srk.table_bytes(tables) + 4 * S + 20 * n + 8
                  + 20 * n + 8 + 16 * n)
        return bound(nbytes, 16 * T * n)

    def b10_bound(tables, T, n):
        # Streams read: u, plus bits and/or stumble and rand_a; nine records
        # written; tables, policy rows, lanes.
        S, A = tables.shape
        per_step = (4 + (4 if tables.mode or tables.dry_nbits else 0)
                    + (8 if tables.noise else 0) + 36)
        nbytes = (per_step * T * n + srk.table_bytes(tables) + psk.rows_bytes(S, A)
                  + 20 * n + 20 * n + 16 * n)
        return bound(nbytes, (A + 14) * T * n)

    T9, T10 = 4096, 1024
    b9, b10 = {}, {}
    for alias, kw in (("absent", {}), ("whisky", {}), ("tomato", {}), ("friend", {"cap": 127})):
        cenv = stoch_env(alias, kw)
        trn = stoch_dqn_trainer(cenv, N_FULL)
        a0, v0 = trn.init(generator=gen)
        greedy = trn.greedy_row(a0.params)
        rand_a = torch.randint(0, trn.A, (T9, N_FULL), dtype=torch.int32, generator=g,
                               device=dev)
        u = torch.rand((T9, N_FULL), generator=g, device=dev)
        step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
        call = (trn.tables, trn.hyper, greedy, v0, step0, rand_a, u,
                *trn.vec.draw_mechanics(g, T9))
        k_ms, outs = timed(lambda: dsk.dqn_stoch_collect(*call), 5)
        p_ms, ref = timed(lambda: dsk.dqn_stoch_collect_reference(*call), 3, warmup=False)
        assert_equal(outs, ref, f"B9 {alias} full width")
        b_ms, b_by = b9_bound(trn.tables, T9, N_FULL)
        place = srk.placement(trn.tables, trn.S)
        b9[alias] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         bound_ms=b_ms, bound_by=b_by, placement=place,
                         shapes={"streams": [T9, N_FULL], "tables": list(trn.tables.shape)})
        log(f"B9 {alias} {kw} T={T9} (tables in {place}) vs plain: 16 outputs equal; kernel "
            f"{k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        del call, outs, ref

        trp = stoch_ppo_trainer(cenv, N_FULL)
        a0, v0 = trp.init(seed=3, generator=gen)
        call = (trp.tables, trp.policy_rows(a0.params), vec_tuple(v0),
                torch.rand((T10, N_FULL), generator=g, device=dev),
                *trp.vec.draw_mechanics(g, T10))
        k_ms, outs = timed(lambda: psk.ppo_stoch_collect(*call), 5)
        p_ms, ref = timed(lambda: psk.ppo_stoch_collect_reference(*call), 3, warmup=False)
        assert_equal(outs, ref, f"B10 {alias} full width")
        b_ms, b_by = b10_bound(trp.tables, T10, N_FULL)
        place = srk.placement(trp.tables, psk.smem_bytes(trp.S, trp.A))
        b10[alias] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                          bound_ms=b_ms, bound_by=b_by, placement=place,
                          shapes={"streams": [T10, N_FULL], "tables": list(trp.tables.shape)})
        log(f"B10 {alias} {kw} T={T10} (rows and tables in {place}) vs plain: 18 outputs "
            f"equal; kernel {k_ms} ms; plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
        del call, outs, ref

    # The main path's widths: B9 and the DQN trainer on whisky (N=128, T=32,
    # U=32), B10 and the PPO trainer on absent (N=1024, T=32, 16 updates of
    # 8192).
    tr = stoch_dqn_trainer(stoch_env("whisky", {}), 128)
    a, v = tr.init(generator=gen)
    a, v, _ = tr.warmup_chunk(a, v, gen, 64)
    call = (tr.tables, tr.hyper, tr.greedy_row(a.params), v,
            torch.tensor([20_000], dtype=torch.int64, device=dev),
            torch.randint(0, tr.A, (32, 128), dtype=torch.int32, generator=g, device=dev),
            torch.rand((32, 128), generator=g, device=dev), *tr.vec.draw_mechanics(g, 32))
    k_ms, outs = timed(lambda: dsk.dqn_stoch_collect(*call), 20)
    p_ms, ref = timed(lambda: dsk.dqn_stoch_collect_reference(*call), 3)
    assert_equal(outs, ref, "B9 whisky main")
    b_ms, b_by = b9_bound(tr.tables, 32, 128)
    b9_main = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                   bound_ms=b_ms, bound_by=b_by, shapes={"streams": [32, 128],
                                                         "tables": list(tr.tables.shape)},
                   device_ms=device_ms(lambda: dsk.dqn_stoch_collect(*call)))
    log(f"B9 main whisky N=128 T=32 vs plain: 16 outputs equal; kernel {k_ms} ms (device "
        f"{b9_main['device_ms']:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")
    trp = stoch_ppo_trainer(stoch_env("absent", {}), PPO_N)
    a0, v0 = trp.init(seed=3, generator=gen)
    call = (trp.tables, trp.policy_rows(a0.params), vec_tuple(v0),
            torch.rand((32, PPO_N), generator=g, device=dev), *trp.vec.draw_mechanics(g, 32))
    k_ms, outs = timed(lambda: psk.ppo_stoch_collect(*call), 20)
    p_ms, ref = timed(lambda: psk.ppo_stoch_collect_reference(*call), 3)
    assert_equal(outs, ref, "B10 absent main")
    b_ms, b_by = b10_bound(trp.tables, 32, PPO_N)
    b10_main = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                    bound_ms=b_ms, bound_by=b_by, shapes={"streams": [32, PPO_N],
                                                          "tables": list(trp.tables.shape)},
                    device_ms=device_ms(lambda: psk.ppo_stoch_collect(*call)))
    log(f"B10 main absent N={PPO_N} T=32 vs plain: 18 outputs equal; kernel {k_ms} ms "
        f"(device {b10_main['device_ms']:.6g} ms); plain {p_ms} ms; bound {b_ms:.6g} ms "
        f"({b_by})")
    del call, outs, ref
    dqn_stoch_box = [a, v]

    def dqn_stoch_window():
        a, v = dqn_stoch_box
        for _ in range(chunks):
            a, v, _, loss = tr.train_chunk(a, v, gen, 32)
        dqn_stoch_box[:] = [a, v]
        return loss

    dqn_stoch_window()  # warm-up window
    rate6 = windows_per_s(dqn_stoch_window, chunks * 32 * 128)
    tr = stoch_ppo_trainer(stoch_env("absent", {}), PPO_N)
    ppo_stoch_box = list(tr.init(seed=1, generator=gen))

    def ppo_stoch_window():
        a, v = ppo_stoch_box
        for _ in range(ppo_chunks):
            a, v, _, loss = tr.train_chunk(a, v, gen, 32)
        ppo_stoch_box[:] = [a, v]
        return loss

    ppo_stoch_window()  # warm-up window
    rate7 = windows_per_s(ppo_stoch_window, ppo_chunks * 32 * PPO_N)
    log(f"fused DQN trainer on whisky N=128, T=32, U=32: {rate6:.6g} env-steps/s; fused PPO "
        f"trainer on absent N={PPO_N}, T=32: {rate7:.6g} env-steps/s (train_chunk, "
        f"{chunks} and {ppo_chunks} chunks per window, median of 5)")
    results["dqn_stoch_collect"] = dict(b9_main, rate=rate6, cases=b9)
    results["ppo_stoch_collect"] = dict(b10_main, rate=rate7, cases=b10)
    parent = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_archive", "parent")
    if os.path.isdir(os.path.join(parent, "safe_grid_agents_torch")):
        # The parent's B4 and B6 wrappers and kernels, built from the
        # unpacked tree, against this tree's, in rounds of parent, new, new,
        # parent: both routes of each at the main path's and the grid-wide
        # commands' shapes.
        header("== 5b. A/B against the parent: B4 and B6, both routes")
        lc.load_package(parent, "sga_parent")
        ab = abl.ab_time(dev, g, "sga_parent", 3, ("b4", "b6"))
        for key, cases in (("dqn_update", ("sokoban", "whisky", "wide")),
                           ("dqn_update_grid", ("hidden512", "batch4096")),
                           ("ppo_optimize", ("island", "absent")),
                           ("ppo_wide", ("island256",))):
            prefix = "b4" if key.startswith("dqn") else "b6"
            results[key]["ab_parent"] = {c: ab[f"{prefix} {c}"] for c in cases}
    else:
        log("A/B against the parent: skipped (no tree in _archive/parent/)")
    log(f"clocks/power after timing: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # -- 6. result lines ---------------------------------------------------------
    meta = {
        "rollout": ("safe_grid_agents_torch/csrc/rollout_kernel.cu",
                    "safe_grid_agents_tpu/ops/rollout_kernel.py:57"),
        "tabq": ("safe_grid_agents_torch/csrc/tabular_kernel.cu",
                 "safe_grid_agents_tpu/ops/tabular_kernel.py:47"),
        "dqn_collect": ("safe_grid_agents_torch/csrc/dqn_kernel.cu",
                        "safe_grid_agents_tpu/ops/dqn_kernel.py:87"),
        "dqn_update": ("safe_grid_agents_torch/csrc/dqn_update_kernel.cu",
                       "safe_grid_agents_tpu/ops/dqn_update_kernel.py:54"),
        "dqn_update_grid": ("safe_grid_agents_torch/csrc/dqn_update_grid.cu",
                             "safe_grid_agents_tpu/ops/dqn_update_kernel.py:54"),
        "ppo_collect": ("safe_grid_agents_torch/csrc/ppo_collect_kernel.cu",
                        "safe_grid_agents_tpu/ops/ppo_collect_kernel.py:47"),
        "ppo_optimize": ("safe_grid_agents_torch/csrc/ppo_kernel.cu",
                         "safe_grid_agents_tpu/ops/ppo_kernel.py:62"),
        "ppo_wide": ("safe_grid_agents_torch/csrc/ppo_wide_kernel.cu",
                     "safe_grid_agents_tpu/ops/ppo_kernel.py:62"),
        "fused_mlp": ("safe_grid_agents_torch/csrc/fused_mlp.cu",
                      "safe_grid_agents_tpu/ops/fused_mlp.py:47"),
        "stoch_rollout": ("safe_grid_agents_torch/csrc/stoch_rollout_kernel.cu",
                          "safe_grid_agents_tpu/ops/stoch_rollout_kernel.py:76"),
        "tabq_stoch": ("safe_grid_agents_torch/csrc/tabular_stoch_kernel.cu",
                       "safe_grid_agents_tpu/ops/tabular_stoch_kernel.py:51"),
        "dqn_stoch_collect": ("safe_grid_agents_torch/csrc/dqn_stoch_kernel.cu",
                              "safe_grid_agents_tpu/ops/dqn_stoch_kernel.py:43"),
        "ppo_stoch_collect": ("safe_grid_agents_torch/csrc/ppo_stoch_collect_kernel.cu",
                              "safe_grid_agents_tpu/ops/ppo_stoch_collect_kernel.py:47"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "env_steps_per_s": r.get("rate"), "shapes": r["shapes"],
        }
        if "device_ms" in r:
            entry["device_ms"] = r["device_ms"]
        if f"{name}_wide" in results:
            entry["wide"] = results[f"{name}_wide"]
        if "cases" in r:
            entry["cases"] = r["cases"]
        for extra in ("ab_parent", "launch_split", "bound_fp32_ms", "bound_fp32_by"):
            if extra in r:
                entry[extra] = r[extra]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
