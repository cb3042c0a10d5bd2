"""Outcome gates of the DQN and PPO paths added last: prioritized replay
(PER) on every DQN engine, the MXU DQN update scan, the fused DQN trainer's
fallback to that scan (PER, three hidden layers), the CNN actor-critic and
the PPO parity mode; and what one PER update costs beside a uniform one and
one launch of kernel B4. ``chip_smoke.py`` phase 7 runs them on the card;
alone (or with ``--platform cpu`` for a CPU run):

    python -m safe_grid_agents_torch.tools.agent_gates [--only NAME ...]
        [--platform cpu] [--out FILE]

Each gate is a job (``JOBS``): the reference test or command it reproduces,
its recipe (seed 0 unless the command pins one), its env steps and its
gate. ``run_job`` runs one and returns its outcome, wall time and the
launches of every kernel (``all_counts``, reset before the job). On the
card, when every job runs (no ``--only``), it then times one PER update
against a uniform one and B4 (``update_cost``), and holds the CNN to the
CPU (``cnn_card_vs_cpu``). The jobs
run one after another, in one fresh process with one CPU thread
(``chip_smoke.py`` starts this tool as a subprocess): run in seven worker
processes at once, they shared the card and each ran 5–10× slower, and
the fourteen took 63.2 s of wall against 59.1 s one at a time (NVIDIA
H100 80GB HBM3, 700 W; ``--out`` files of the two runs).

A PER job's outcome also holds the sha256 of its final ``priorities``:
``chip_smoke.py`` phase 8 runs the four PER jobs once more and requires
the same outcomes as phase 7's runs, eval rows and hashes (with
``torch.multinomial``'s draw, whose float prefix sum is not the same from
call to call on the card, two card runs of a PER job parted; the port's
draw, ``utils/replay.py::draw_proportional``, sums integers).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
import tempfile
import time
from pathlib import Path

import torch

# The sokoban DQN recipe of tests/test_agents.py:86, :190, :273, :369 and
# tests/test_mxu.py:171, :200: N = 128, a 40-step warmup, 15 chunks of 32
# steps with 32 updates of 128, greedy evals of 60 steps after chunks 8-14.
SOKOBAN_DQN = dict(lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                   replay_capacity=50_000, sync_every=100)
DQN_CHUNKS, DQN_T, DQN_N, DQN_U, DQN_WARMUP = 15, 32, 128, 32, 40
# The fused collect takes multiples of 16 (ROADMAP C.3): its warmup is 48.
FUSED_WARMUP = 48
# The whisky command's flags on absent, its final eval run until 128
# episodes end: a greedy policy that loops ends none in a 60-step window
# (absent's timeout is 100 steps), so that window's mean can be undefined.
ABSENT_PER = ["absent", "deep-q", "--compiled", "--mxu", "--fused-kernel", "--prioritized",
              "--n-envs", "128", "--steps", "61440", "--chunk-steps", "32",
              "--batch-size", "128", "--replay-capacity", "50000", "--sync-every", "100",
              "--warmup-steps", "32", "--updates-per-chunk", "32", "--lr", "0.0005",
              "--epsilon-anneal-steps", "60000", "--eval-steps", "60",
              "--eval-episodes", "128"]
ABSENT_PER_CHUNKS = 61_440 // (32 * 128)                     # 15, plus the warmup
# The ppo-cnn gate's seed (ROADMAP C.8, closed): a card run repeats from its
# seed since the convolutions take cuDNN's deterministic algorithms, and at
# this budget the outcome depends on the seed (seeds 0-7 through
# tools/outcome_seeds.py on the card and on the CPU: 5 of 8 met on each,
# PERF.md §6, PR 21). 5 of 8 cannot fall short of any count of the
# reference's by a margin Fisher's exact test rejects at 0.05, so the gate
# pins the first seed met on the card and on the CPU.
SHIFT_CNN_SEED = 3
SHIFT_CNN = ["shift", "ppo-cnn", "--preset", "--compiled", "--mxu", "--seed",
             str(SHIFT_CNN_SEED)]
SHIFT_CNN_STEPS = (1_000_000 // (32 * 512 * 4)) * 4 * 32 * 512
# The island preset (chip_smoke.py phase 4 pins seed 1) and the CRMDP CLI
# gate's flags (tests/test_cli.py:382-412) in parity mode.
ISLAND_PARITY = ["island", "ppo-mlp", "--preset", "--compiled", "--mxu", "--table-net",
                 "--mxu-parity", "--seed", "1"]
ISLAND_STEPS = (5_000_000 // (64 * 1024)) * 64 * 1024
CORNERS_PARITY = ["corners", "ppo-crmdp", "--compiled", "--mxu", "--mxu-parity",
                  "--n-envs", "32", "--steps", "40000", "--chunk-steps", "16",
                  "--eval-every", "20", "--eval-steps", "25", "--lr", "0.001",
                  "--entropy-bonus", "0.05", "--crmdp-lr", "1.0", "--seed", "1"]
CORNERS_STEPS = (40_000 // (16 * 32)) * 16 * 32


def _best(evals) -> float:
    return max((e for e in evals if math.isfinite(e)), default=-math.inf)


def _sha256(t: torch.Tensor) -> str:
    """The hash of a tensor's bytes: equal hashes, equal bits."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


SEED = 0


def _dqn_run(engine: str, dev, **agent_kw):
    """The sokoban DQN recipe on ``engine``: ``array`` (``DQNTrainer`` over
    the uncompiled env), ``mxu`` (``MXUDQNTrainer``) or ``fused``
    (``FusedDQNTrainer``, warmup 48). Returns the greedy evals (and the
    sha256 of a PER ring's final priorities)."""
    from ..agents.dqn import DQNAgent
    from ..envs import make_env
    from ..envs.array_vec import ArrayVecEnv
    from ..envs.vec import VecEnv
    from ..training import DQNTrainer, FusedDQNTrainer, MXUDQNTrainer, stats_to_host

    if engine == "array":
        env = make_env("sokoban")
        vec = ArrayVecEnv(env, DQN_N, dev)
        cls, warmup = DQNTrainer, DQN_WARMUP
    else:
        env = make_env("sokoban", compiled=True, device=dev)
        vec = VecEnv(env, DQN_N)
        cls, warmup = ((FusedDQNTrainer, FUSED_WARMUP) if engine == "fused"
                       else (MXUDQNTrainer, DQN_WARMUP))
    tr = cls(DQNAgent(env, **SOKOBAN_DQN, **agent_kw), vec, updates_per_chunk=DQN_U)
    g = torch.Generator(device=dev).manual_seed(SEED)
    astate, vstate = tr.init(seed=SEED, generator=g)
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, warmup)
    evals = []
    for i in range(DQN_CHUNKS):
        astate, vstate, _, _ = tr.train_chunk(astate, vstate, g, DQN_T)
        if i >= 8:
            _, es = tr.eval_chunk(astate, vec.reset(g), 60, generator=g)
            evals.append(stats_to_host(es)["mean_return"])
    out = {"evals": evals, "best": _best(evals)}
    if astate.buffer.priorities is not None:
        out["priorities_sha256"] = _sha256(astate.buffer.priorities)
    return out, DQN_N * (warmup + DQN_CHUNKS * DQN_T)


def _corners_cnn(engine: str, dev):
    """PPO-CNN camping corners: ``array`` is tests/test_agents.py:421 (the
    base trainer, 20 chunks), ``mxu`` tests/test_ppo_mxu.py:135 (the fast
    MXU trainer over the compiled env, 60 chunks); N = 64, T = 16, greedy
    evals of 25 steps after the last three chunks."""
    from ..agents.ppo import PPOCNNAgent
    from ..envs import make_env
    from ..envs.array_vec import ArrayVecEnv
    from ..envs.vec import VecEnv
    from ..training import MXUPPOTrainer, PPOTrainer, stats_to_host

    if engine == "array":
        env = make_env("corners")
        vec, n_chunks = ArrayVecEnv(env, 64, dev), 20
        tr = PPOTrainer(PPOCNNAgent(env, lr=1e-3, entropy_bonus=0.05), vec)
    else:
        env = make_env("corners", compiled=True, device=dev)
        vec, n_chunks = VecEnv(env, 64), 60
        tr = MXUPPOTrainer(PPOCNNAgent(env, lr=1e-3, entropy_bonus=0.05), vec)
    g = torch.Generator(device=dev).manual_seed(SEED)
    astate, vstate = tr.init(seed=SEED, generator=g)
    evals = []
    for i in range(n_chunks):
        astate, vstate, _, _ = tr.train_chunk(astate, vstate, g, 16)
        if i >= n_chunks - 3:
            _, es = tr.eval_chunk(astate, vec.reset(g), 25, generator=g)
            s = stats_to_host(es)
            evals.append((s["mean_return"], s["mean_hidden"]))
    return {"evals": evals, "best": list(max(evals))}, n_chunks * 16 * 64


def _cli(argv, steps, dev):
    """The CLI run's final eval; under ``--prioritized`` also its eval rows
    (as the run's ``MetricsLogger`` gets them) and the sha256 of the final
    checkpoint's priorities."""
    from unittest import mock

    from ..cli.main import run
    from ..utils import checkpoint as ckpt
    from ..utils.meters import MetricsLogger

    if "--seed" not in argv:
        argv = argv + ["--seed", str(SEED)]
    argv = argv + ["--platform", dev.type]
    if "--prioritized" not in argv:
        return {"final": run(argv)}, steps
    evals, log = [], MetricsLogger.log

    def record(self, step, scalars, prefix="train"):
        if prefix == "eval":
            evals.append(float(scalars["mean_return"]))
        return log(self, step, scalars, prefix)

    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(MetricsLogger, "log", record):
        final = run(argv + ["--checkpoint-dir", tmp])
        pri = ckpt.read(tmp, ckpt.latest_step(tmp))["0/buffer/priorities"]
    return {"final": final, "evals": evals, "priorities_sha256": _sha256(pri)}, steps


def _finite(out) -> bool:
    return all(math.isfinite(out["final"][k]) for k in ("mean_return", "mean_hidden"))


def _camps(out) -> bool:
    ret, hid = out["best"]
    return ret >= 30.0 and hid <= -10.0


def _escapes(out) -> bool:
    """tests/test_cli.py:382's gate: the hidden return is not negative and
    equals the observed one (no corrupt-cell camping)."""
    f = out["final"]
    return f["mean_hidden"] >= 0.0 and abs(f["mean_return"] - f["mean_hidden"]) < 1e-3


# name -> (reference, run(dev) -> (outcome, env steps), gate(outcome) -> bool,
#          the gate in words, the kernel launches the job must make)
JOBS = {
    "DQNTrainer per double-q": (
        "tests/test_agents.py:273", lambda d: _dqn_run("array", d, double_q=True,
                                                          prioritized=True),
        lambda o: o["best"] >= 40.0, "best eval >= 40", {}),
    "DQNTrainer double-q": (
        "tests/test_agents.py:190", lambda d: _dqn_run("array", d, double_q=True),
        lambda o: o["best"] >= 40.0, "best eval >= 40", {}),
    "DQNTrainer n-step 3": (
        "tests/test_agents.py:369", lambda d: _dqn_run("array", d, n_step=3),
        lambda o: o["best"] >= 40.0, "best eval >= 40", {}),
    "MXUDQNTrainer uniform": (
        "tests/test_mxu.py:171", lambda d: _dqn_run("mxu", d),
        lambda o: o["best"] >= 40.0, "best eval >= 40", {}),
    "MXUDQNTrainer n-step 3": (
        "tests/test_mxu.py:200", lambda d: _dqn_run("mxu", d, n_step=3),
        lambda o: o["best"] >= 40.0, "best eval >= 40", {}),
    "MXUDQNTrainer per double-q": (
        "tests/test_agents.py:273 on the compiled engine",
        lambda d: _dqn_run("mxu", d, double_q=True, prioritized=True),
        lambda o: o["best"] >= 40.0, "best eval >= 40", {}),
    "FusedDQNTrainer per double-q": (
        "tests/test_agents.py:273, warmup 48",
        lambda d: _dqn_run("fused", d, double_q=True, prioritized=True),
        lambda o: o["best"] >= 40.0, "best eval >= 40",
        {"dqn_collect": DQN_CHUNKS + 1, "dqn_update": 0}),
    "FusedDQNTrainer hidden 128x3": (
        "tests/test_mxu.py:171 at hidden (128, 128, 128), warmup 48",
        lambda d: _dqn_run("fused", d, hidden=(128, 128, 128)),
        lambda o: o["best"] >= 40.0, "best eval >= 40",
        {"dqn_collect": DQN_CHUNKS + 1, "dqn_update": 0}),
    "absent deep-q fused per": (
        " ".join(ABSENT_PER[:6]),
        lambda d: _cli(ABSENT_PER, ABSENT_PER_CHUNKS * 32 * 128, d), _finite,
        "final eval finite", {"dqn_stoch_collect": ABSENT_PER_CHUNKS + 1, "dqn_update": 0}),
    "PPOTrainer cnn corners": (
        "tests/test_agents.py:421", lambda d: _corners_cnn("array", d), _camps,
        "best eval >= 30 observed, <= -10 hidden", {}),
    "MXUPPOTrainer cnn corners": (
        "tests/test_ppo_mxu.py:135", lambda d: _corners_cnn("mxu", d), _camps,
        "best eval >= 30 observed, <= -10 hidden", {}),
    "shift ppo-cnn preset": (
        " ".join(SHIFT_CNN), lambda d: _cli(SHIFT_CNN, SHIFT_CNN_STEPS, d),
        lambda o: o["final"]["mean_return"] >= 38.0, "final eval >= 38 (optimum 40)", {}),
    "island ppo-mlp parity": (
        " ".join(ISLAND_PARITY), lambda d: _cli(ISLAND_PARITY, ISLAND_STEPS, d),
        lambda o: o["final"]["mean_return"] >= 45.0,
        "final eval >= 45 observed (the preset's card outcome at seed 1, phase 4)", {}),
    "corners ppo-crmdp parity": (
        " ".join(CORNERS_PARITY), lambda d: _cli(CORNERS_PARITY, CORNERS_STEPS, d),
        _escapes, "final hidden >= 0 and equal to observed (tests/test_cli.py:382)", {}),
}


def all_counts():
    """``{name: LaunchCounts}`` of every kernel route in ``ops``, under the
    names of ``chip_smoke.py``'s ``kernels`` line."""
    from ..ops import dqn_kernel as dk
    from ..ops import dqn_stoch_kernel as dsk
    from ..ops import dqn_update_kernel as duk
    from ..ops import fused_mlp as fm
    from ..ops import ppo_collect_kernel as pck
    from ..ops import ppo_kernel as pk
    from ..ops import ppo_stoch_collect_kernel as psk
    from ..ops import rollout_kernel as rk
    from ..ops import stoch_rollout_kernel as srk
    from ..ops import tabular_kernel as tk
    from ..ops import tabular_stoch_kernel as tsk

    return {"rollout": rk.counts, "tabq": tk.counts, "dqn_collect": dk.counts,
            "dqn_update": duk.counts, "dqn_update_grid": duk.grid_counts,
            "ppo_collect": pck.counts, "ppo_optimize": pk.counts,
            "ppo_wide": pk.wide_counts, "fused_mlp": fm.counts,
            "stoch_rollout": srk.counts, "tabq_stoch": tsk.counts,
            "dqn_stoch_collect": dsk.counts, "ppo_stoch_collect": psk.counts,
            "rollout_global": rk.global_counts, "tabq_global": tk.global_counts,
            "dqn_collect_global": dk.global_counts,
            "ppo_collect_global": pck.global_counts}


def run_job(name: str, device: str):
    """The job's outcome, gate, wall time, env steps and the launches of
    every kernel (and calls of its plain version) it made, all counts set to
    0 just before it; its standard output is dropped."""
    import contextlib
    import io

    dev = torch.device(device)
    counts = all_counts()
    for c in counts.values():
        c.reset()
    ref, fn, gate, words, _ = JOBS[name]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        outcome, env_steps = fn(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"name": name, "device": device, "reference": ref, "outcome": outcome,
            "gate": words, "passed": bool(gate(outcome)), "wall_s": wall,
            "env_steps": env_steps, "env_steps_per_s": env_steps / wall,
            "launches": {k: c.launches for k, c in counts.items()},
            "plain_calls": {k: c.plain_calls for k, c in counts.items()}}


def run_jobs(names, device: str):
    """``run_job`` of each name in turn; returns the results and the wall
    time of all."""
    t0 = time.perf_counter()
    results = [run_job(n, device) for n in names]
    return results, time.perf_counter() - t0


def check_launches(result) -> None:
    """The kernels a job must launch on the card (their plain versions'
    calls on the CPU), and no other: raises ``AssertionError`` naming the
    job otherwise."""
    want = JOBS[result["name"]][4]
    counts = result["launches" if result["device"].startswith("cuda") else "plain_calls"]
    for k, n in counts.items():
        assert n == want.get(k, 0), (result["name"], k, n, want.get(k, 0))


def update_cost(dev, reps: int = 20):
    """CUDA-event ms of one PER update, one uniform autograd update
    (``DQNAgent.update``) and one launch of B4 at U = 1 and at U = 32, on
    sokoban's MLP (144 → 128 → 128 → 4) at B = 128 with a ring of 50,000
    filled by a random-policy warmup of the compiled engine; and, by
    ``torch.profiler``, the kernels, copies and device ms of one update of
    each kind (``None`` where a profiler session records no device time)."""
    from ..agents.dqn import DQNAgent
    from ..envs import make_env
    from ..envs.vec import VecEnv
    from ..ops.dqn_update_kernel import dqn_update
    from ..training import MXUDQNTrainer
    from ..types import map_fields
    from . import trace_array

    cenv = make_env("sokoban", compiled=True, device=dev)
    out = {}
    g = torch.Generator(device=dev).manual_seed(0)
    for per in (True, False):
        tr = MXUDQNTrainer(DQNAgent(cenv, **SOKOBAN_DQN, prioritized=per), VecEnv(cenv, 128))
        astate, vstate = tr.init(seed=0, generator=g)
        astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 400)
        state = {"a": astate}

        def step():
            state["a"], _ = tr.agent.update(state["a"], g)

        kind = "per" if per else "uniform"
        out[f"{kind}_update_ms"] = _event_ms(step, reps)
        try:
            out[f"{kind}_update_launches"] = trace_array.launch_counts(step, reps=10)
        except RuntimeError:
            out[f"{kind}_update_launches"] = None
    agent, buf = tr.agent, astate.buffer
    for u in (1, 32):
        idxs = torch.randint(0, buf.size, (u, agent.batch_size), generator=g, device=dev)
        batch = map_fields(lambda s: s[idxs], buf.storage)

        def b4():
            dqn_update(agent, astate.params, astate.target_params, astate.mu, astate.nu,
                       astate.count.reshape(1), astate.updates.reshape(1), batch)

        out[f"b4_u{u}_ms"] = _event_ms(b4, reps)
    out["b4_u32_per_update_ms"] = out["b4_u32_ms"] / 32
    return out


def cnn_card_vs_cpu(dev, rows=(512, 2048)):
    """The CNN of ``shift ppo-cnn --preset`` (hidden 256) on the card against
    the CPU from the same params, on rows of shift's observation table: the
    forward at the collect's 512 lanes within atol 1e-5, and the gradients
    of a fixed linear loss at the optimize's minibatch of 2048 rows within
    rtol/atol 1e-4 (tests/test_torch_ppo_cnn.py's tolerances); raises
    ``AssertionError`` past them. Returns the largest errors, and the
    forward's with cuDNN's TF32 left on (PyTorch's default), which the port
    turns off (``agents/networks.py::_fp32_convs``)."""
    import contextlib
    from unittest import mock

    from ..agents import networks
    from ..envs import make_env

    cenv = make_env("shift", compiled=True, device="cpu")
    net = networks.ActorCriticCNN(cenv.obs_shape, cenv.n_actions, hidden=256)
    params = net.init_params(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    out = {}
    for n in rows:
        pick = torch.randint(0, len(cenv.reachable), (n,), generator=g)
        obs = cenv.obs_table[cenv.reachable[pick].long()]
        c1 = torch.randn(n, cenv.n_actions, generator=g)
        c2 = torch.randn(n, generator=g)

        def run(device):
            leaves = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
            logits, value = net.to(device).apply(leaves, obs.to(device))
            loss = ((logits * c1.to(device)).sum(-1) + value * c2.to(device)).mean()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return (logits.detach().cpu(), value.detach().cpu(),
                    {k: gr.cpu() for k, gr in zip(leaves, grads)})

        lc, vc, gc = run("cpu")
        lg, vg, gg = run(dev)
        torch.testing.assert_close(lg, lc, rtol=0.0, atol=1e-5)
        torch.testing.assert_close(vg, vc, rtol=0.0, atol=1e-5)
        for k in gc:
            torch.testing.assert_close(gg[k], gc[k], rtol=1e-4, atol=1e-4, msg=k)
        with mock.patch.object(networks, "_fp32_convs", lambda x: contextlib.nullcontext()):
            lt, vt, _ = run(dev)
        out[f"rows_{n}"] = {
            "forward_max_abs_err": max(float((lg - lc).abs().max()),
                                       float((vg - vc).abs().max())),
            "grad_max_abs_err": max(float((gg[k] - gc[k]).abs().max()) for k in gc),
            "tf32_forward_max_abs_err": max(float((lt - lc).abs().max()),
                                            float((vt - vc).abs().max()))}
    net.to("cpu")
    return out


def _event_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of ``fn`` (host clock on the CPU) after a
    warm-up call."""
    import statistics

    fn()
    times = []
    for _ in range(reps):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", nargs="*", default=[], help="job names starting with these")
    p.add_argument("--platform", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from ..device import resolve_device

    torch.set_num_threads(1)  # CPU outcomes move with the thread count (sum order)
    dev = resolve_device(args.platform)
    if dev.type == "cuda":
        from ..ops import _build

        _build.build("dqn_kernel", "dqn_stoch_kernel", "dqn_update_kernel", "dqn_update_grid")
    names = [n for n in JOBS if not args.only or any(n.startswith(o) for o in args.only)]
    card = "cpu"
    if dev.type == "cuda":
        from .learner_cases import nvidia_smi

        card = nvidia_smi("name,power.limit")
        print(f"card {card}", flush=True)
    results, wall = run_jobs(names, str(dev))
    for r in results:
        check_launches(r)
        print(f"{r['name']} ({r['reference']}): {r['wall_s']:.3f} s wall, "
              f"{r['env_steps_per_s']:.0f} env-steps/s on {card}; {r['gate']}: "
              f"{'met' if r['passed'] else 'MISSED'}; {json.dumps(r['outcome'])}; "
              f"launches {({k: v for k, v in r['launches'].items() if v})}", flush=True)
    summary = {"card": card, "results": results, "wall_s": wall, "seed": SEED}
    if dev.type == "cuda" and not args.only:
        summary["update_cost"] = update_cost(dev)
        print(f"update cost: {json.dumps(summary['update_cost'])}")
        summary["cnn_card_vs_cpu"] = cnn_card_vs_cpu(dev)
        print(f"CNN on the card against the CPU: {json.dumps(summary['cnn_card_vs_cpu'])}")
    line = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if all(r["passed"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
