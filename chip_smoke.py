#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure raises and exits non-zero; nothing is skipped):

1. toolchain and card; build all four kernels (one nvcc each, in parallel)
   and print nvcc's ``-Xptxas -v`` report;
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
3c. DQN update kernel B4 against its plain version (autograd + Adam) for
   the table net, the MLP and double-Q at hidden 128×128, B=128: 8 updates
   with sync_every=3 from a fresh state, then 8 more from the result
   (params, target, μ, ν to rtol 2e-4 / atol 1e-6, loss to rtol 2e-5,
   counters equal);
4. the main path with every launch count set to 0: the rollout engine at
   4096 lanes as the benchmark drives it, the CLI's
   ``shift tabular-q --compiled --mxu --fused-kernel --preset``, then the
   CLI's ``sokoban deep-q --compiled --mxu --fused-kernel ...`` (N=128,
   100k steps, 3-step windows) on the card; all four kernels must have
   launched and no plain version may have run; the shift eval must reach
   ≥ 38 (optimum 40) and the sokoban eval ≥ 40 observed (optimum 45/35);
5. timing: B1 at N=4096, T=32768 and the fused tabular trainer at N=4096,
   T=8192; B3 at the DQN command's N=128, T=32 and at N=4096, T=4096; B4
   at U=32, B=128 and at U=256, B=512; the fused DQN trainer's train_chunk
   at N=128 — env-steps/s (median of 5 synchronised windows), CUDA-event
   kernel times beside the plain version's time and the bound, with the
   outputs held against the plain version once more;
6. one ``{"kernels": [...]}`` JSON line, the card's name and power limit,
   and the last line ``{"ok": true, "device": {...}}``.

Without a card, or run from a directory that holds only this file, it
exits non-zero before printing any result. It imports no JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
N_FULL = 4096
KERNEL_SOURCES = ("rollout_kernel", "tabular_kernel", "dqn_kernel", "dqn_update_kernel")
DQN_MAIN = [
    "sokoban", "deep-q", "--compiled", "--mxu", "--fused-kernel",
    "--n-envs", "128", "--steps", "100000", "--chunk-steps", "32",
    "--batch-size", "128", "--replay-capacity", "50000", "--sync-every", "100",
    "--warmup-steps", "32", "--updates-per-chunk", "32", "--lr", "0.0005",
    "--epsilon-anneal-steps", "60000", "--n-step", "3",
]


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


def bound(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        from safe_grid_agents_torch.agents.dqn import DQNAgent
        from safe_grid_agents_torch.agents.tabular import TabularQAgent
        from safe_grid_agents_torch.envs.vec import VecEnv
        from safe_grid_agents_torch.training import FusedDQNTrainer, FusedTabularQTrainer
        from safe_grid_agents_torch.types import map_fields
    except ImportError as e:
        print(f"chip_smoke: the port's package is not next to this script ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")

    # -- 1. toolchain, card, build ------------------------------------------
    log("== 1. toolchain and card")
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

    errs = {"rollout": 0.0, "tabq": 0.0, "dqn_collect": 0.0, "dqn_update": 0.0}
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

    # -- 2. B1 against its plain version --------------------------------------
    log("== 2. rollout kernel vs plain (bitwise), N=4096, T=1024")
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
    log("== 3. fused tabular-Q kernel vs plain")
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
    log("== 3b. DQN collect kernel B3 vs plain (bitwise), sokoban")
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
    log("== 3c. DQN update kernel B4 vs plain (autograd + Adam), sokoban, "
        "hidden 128x128, B=128, 2 x 8 updates, sync_every=3")
    for table, double_q in ((True, False), (False, False), (True, True)):
        tr = dqn_trainer(128, table=table, double_q=double_q, sync_every=3, n_step=3)
        astate, vstate = tr.init()
        astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 64)
        idxs = torch.randint(0, astate.buffer.size, (8, 128), generator=g, device=dev)
        batch = map_fields(lambda x: x[idxs], astate.buffer.storage)
        args = (astate.params, astate.target_params, astate.mu, astate.nu,
                astate.count.reshape(1), astate.updates.reshape(1))
        for rnd in range(2):  # from a fresh state, then with counters at 8
            outs = duk.dqn_update(tr.agent, *args, batch)
            torch.cuda.synchronize()
            ref = duk.dqn_update_reference(tr.agent, *args, batch)
            err = 0.0
            for got, want in zip(outs[:4], ref[:4]):
                for k in want:
                    torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=1e-6)
                    err = max(err, float((got[k] - want[k]).abs().max()))
            assert_equal(outs[4:6], ref[4:6], "B4 counters")
            torch.testing.assert_close(outs[6], ref[6], rtol=2e-5, atol=0.0)
            err = max(err, float((outs[6] - ref[6]).abs().max()))
            errs["dqn_update"] = max(errs["dqn_update"], err)
            log(f"B4 table={table!s:5s} double_q={double_q!s:5s} round {rnd}: max |err| "
                f"{err:.3g} (rtol 2e-4, atol 1e-6; loss rtol 2e-5), loss "
                f"{float(outs[6][0]):.6g}, counters {int(outs[4][0])}/{int(outs[5][0])}")
            args = ref[:6]

    # -- 4. the main path -------------------------------------------------------
    log("== 4. main path: rollout engine at 4096 lanes, the shift preset, the sokoban DQN command")
    for c in (rk.counts, tk.counts, dk.counts, duk.counts):
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
    counts = {"rollout": rk.counts, "tabq": tk.counts, "dqn_collect": dk.counts,
              "dqn_update": duk.counts}
    launches = {k: c.launches for k, c in counts.items()}
    plain = {k: c.plain_calls for k, c in counts.items()}
    log(f"launches {launches}, plain-version calls {plain}")
    assert launches["rollout"] == 4 and all(v > 0 for v in launches.values()), launches
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

    # -- 5. full width: rates, kernel times, plain times, bounds --------------
    log("== 5. timing: kernels, plain versions, bounds, trainer rates")
    results = {}
    S, A = eng.tables.shape
    T1 = 32768
    actions = torch.randint(0, A, (T1, N_FULL), dtype=torch.int32, generator=g, device=dev)
    st0 = eng.reset()
    rate1 = windows_per_s(lambda: eng.run_random_reduced(st0, gen, T1), T1 * N_FULL)
    k_ms = cuda_ms(lambda: rk.rollout(eng.tables, st0, actions), 5)
    p_ms = cuda_ms(lambda: rk.rollout_reference(eng.tables, st0, actions), 3)
    assert_equal(rk.rollout(eng.tables, st0, actions),
                 rk.rollout_reference(eng.tables, st0, actions), "B1 full width")
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
    k_ms = cuda_ms(lambda: tk.tabq(tr.tables, tr.hyper, a0.q, v0, step0, rand_a, u), 5)
    p_ms = cuda_ms(lambda: tk.tabq_reference(tr.tables, tr.hyper, a0.q, v0, step0, rand_a, u), 3)
    outs = tk.tabq(tr.tables, tr.hyper, a0.q, v0, step0, rand_a, u)
    ref = tk.tabq_reference(tr.tables, tr.hyper, a0.q, v0, step0, rand_a, u)
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
        k_ms = cuda_ms(lambda: dk.dqn_collect(*call), 20 if label == "main" else 5)
        p_ms = cuda_ms(lambda: dk.dqn_collect_reference(*call), 3)
        assert_equal(dk.dqn_collect(*call), dk.dqn_collect_reference(*call), f"B3 {label}")
        b_ms, b_by = b3_bound(trn.S, trn.A, T, n)
        key = "dqn_collect" if label == "main" else "dqn_collect_wide"
        results[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                            bound_ms=b_ms, bound_by=b_by,
                            shapes={"rand_a": [T, n], "u": [T, n], "greedy": [trn.S]})
        log(f"B3 {label} N={n} T={T} vs plain: 16 outputs equal; kernel {k_ms} ms; "
            f"plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")

    D, (H1, H2), A = tr.agent.obs_flat.shape[1], tr.agent.hidden, tr.A
    for U, B, label in ((32, 128, "main"), (256, 512, "wide")):
        idxs = torch.randint(0, d_state.buffer.size, (U, B), generator=g, device=dev)
        batch = map_fields(lambda x: x[idxs], d_state.buffer.storage)
        call = (tr.agent, d_state.params, d_state.target_params, d_state.mu, d_state.nu,
                d_state.count.reshape(1), d_state.updates.reshape(1), batch)
        k_ms = cuda_ms(lambda: duk.dqn_update(*call), 10 if label == "main" else 3)
        p_ms = cuda_ms(lambda: duk.dqn_update_reference(*call), 3)
        outs, ref = duk.dqn_update(*call), duk.dqn_update_reference(*call)
        err = 0.0
        for got, want in zip(outs[:4], ref[:4]):
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=1e-6)
                err = max(err, float((got[k] - want[k]).abs().max()))
        torch.testing.assert_close(outs[6], ref[6], rtol=2e-5, atol=0.0)
        errs["dqn_update"] = max(errs["dqn_update"], err)
        b_ms, b_by = b4_bound(tr.S, D, H1, H2, A, U, B, tr.agent.double_q)
        key = "dqn_update" if label == "main" else "dqn_update_wide"
        results[key] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                            bound_ms=b_ms, bound_by=b_by,
                            shapes={"batch": [U, B], "hidden": [H1, H2], "obs": [tr.S, D]})
        log(f"B4 {label} U={U} B={B} vs plain: max |err| {err:.3g}; kernel {k_ms} ms; "
            f"plain {p_ms} ms; bound {b_ms:.6g} ms ({b_by})")

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
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "env_steps_per_s": r["rate"], "shapes": r["shapes"],
        }
        if f"{name}_wide" in results:
            entry["wide"] = results[f"{name}_wide"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
