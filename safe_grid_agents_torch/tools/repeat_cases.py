"""Whether a learner run repeats bit for bit from its seed, as the
reference's runs do (XLA is deterministic). ``chip_smoke.py`` phase 8d runs
the repeats on the card; alone (or with ``--platform cpu`` for a CPU run):

    python -m safe_grid_agents_torch.tools.repeat_cases [--only NAME ...]
        [--platform cpu] [--out FILE]
    python -m safe_grid_agents_torch.tools.repeat_cases --probe [--only NAME ...]
        [--out FILE]        # from the repository root (it reads chip_smoke.py)
    python -m safe_grid_agents_torch.tools.repeat_cases --cnn-chunk   # the card only

* The repeats (default): each path of ``PATHS`` runs twice from one seed at
  a short budget, a few chunks; every leaf of its final learner state (and
  of the engine's lanes and the generator, for a CLI run: its final
  checkpoint) and every eval row must be bitwise the first run's, compared
  by sha256. A float sum whose order changes from run to run (an atomic
  ``index_add_``, a cuDNN algorithm that adds partial sums with atomics)
  shows here as a leaf whose hash differs.
* ``--probe``: every CLI command of ``chip_smoke.py`` phases 4, 6 and 7,
  cut to ``PROBE_CHUNKS`` chunks, and the trainer runs of phases 6 and 7 at
  short budgets, under ``torch.use_deterministic_algorithms(True,
  warn_only=True)``: the operations PyTorch warns of as nondeterministic,
  each with the port's file and line that called it and the runs that
  reached it. In that mode PyTorch swaps some ops (``index_add_``,
  ``scatter_add_``, ``cumsum`` on CUDA) for deterministic versions without
  a warning, so the probe also counts every call of the ops that are
  nondeterministic on CUDA by default (``WATCH``, ``OpCensus``), by dtype
  and calling line. A listed op is a lead, not a verdict: an integer
  ``index_add_`` is exact in any order (ROADMAP C lists each one and what
  was done about it).
* ``--cnn-chunk``: the cost of the fixed order, one ``shift ppo-cnn
  --preset`` chunk on cuDNN's deterministic algorithms against the ones it
  picks by default (``cnn_chunk_ms``).

The last line is a JSON summary; the exit code is 1 if a repeat parted.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..utils import checkpoint as ckpt

SEED = 0
CHUNKS = 3          # chunks of each repeated CLI run
PROBE_CHUNKS = 2    # chunks of each probed CLI command
# The phase-6 recipes repeated (chip_smoke.py's ARRAY_DEFAULT, MXU_TAB and
# ARRAY_SUITE), phase 7's ppo-cnn gate, and phase 4's and 7's commands that
# reach the probe's other leads.
ARRAY_SUITE = ["tabular-q", "--n-envs", "256", "--chunk-steps", "128", "--lr", "0.2",
               "--epsilon-anneal-steps", "600000", "--epsilon-final", "0.03"]
CLI_PATHS = {
    "shift tabular-q --lr 0.2": ["shift", "tabular-q", "--lr", "0.2"],
    "shift tabular-q --compiled --mxu": [
        "shift", "tabular-q", "--compiled", "--mxu", "--n-envs", "64", "--chunk-steps", "128",
        "--eval-every", "1", "--eval-steps", "30", "--lr", "0.2",
        "--epsilon-anneal-steps", "20000"],
    "sokoban2 tabular-q (suite recipe)": ["sokoban2"] + ARRAY_SUITE + ["--eval-every", "1"],
    "friend tabular-q (suite recipe)": ["friend"] + ARRAY_SUITE + ["--eval-every", "1"],
    "shift ppo-cnn --preset --compiled --mxu": [
        "shift", "ppo-cnn", "--preset", "--compiled", "--mxu", "--eval-every", "1"],
    # The probe's other leads on the card (ROADMAP C): the policy rows' CDF
    # (a cumsum over each row's actions) of the fused PPO collect, the ring
    # writes and the gathers' backward of DQN, the table net's row reads'
    # backward (an accumulating index write) and CRMDP's attribution.
    "island ppo-mlp --preset (fused)": [
        "island", "ppo-mlp", "--preset", "--compiled", "--mxu", "--table-net",
        "--fused-kernel", "--eval-every", "1"],
    "sokoban deep-q (fused)": [
        "sokoban", "deep-q", "--compiled", "--mxu", "--fused-kernel", "--n-envs", "128",
        "--chunk-steps", "32", "--batch-size", "128", "--replay-capacity", "50000",
        "--sync-every", "100", "--warmup-steps", "32", "--updates-per-chunk", "32",
        "--lr", "0.0005", "--epsilon-anneal-steps", "60000", "--n-step", "3",
        "--eval-every", "1"],
    "island ppo-mlp --mxu-parity": [
        "island", "ppo-mlp", "--preset", "--compiled", "--mxu", "--table-net", "--mxu-parity",
        "--eval-every", "1"],
    "corners ppo-crmdp --mxu": [
        "corners", "ppo-crmdp", "--compiled", "--mxu", "--n-envs", "32", "--chunk-steps", "16",
        "--eval-every", "1", "--eval-steps", "25", "--lr", "0.001", "--entropy-bonus", "0.05",
        "--crmdp-lr", "1.0"],
}
CNN_CHUNKS = 4      # chunks of the corners CNN trainers (tests/test_agents.py:421's loop)
# Phase 7's jobs that are CLI commands: the probe runs them cut, as commands.
CLI_JOBS = ("absent deep-q fused per", "shift ppo-cnn preset", "island ppo-mlp parity",
            "corners ppo-crmdp parity")


def digest(x) -> str:
    """sha256 of a leaf: a tensor's bytes (with its dtype and shape), a
    generator's state, a number's ``repr``."""
    h = hashlib.sha256()
    if isinstance(x, torch.Generator):
        x = x.get_state()
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    else:
        h.update(repr(x).encode())
    return h.hexdigest()


def tree_digests(tree) -> dict:
    """``{"a/b": sha256}`` of every leaf of a state tree (``ckpt.leaves``)."""
    return {"/".join(p): digest(x) for p, x in ckpt.leaves(tree)}


def row_digest(row: dict) -> str:
    """sha256 of an eval row as JSON text (a NaN row matches itself)."""
    return hashlib.sha256(json.dumps(row, sort_keys=True).encode()).hexdigest()


def cut(argv, n_chunks: int):
    """``argv`` with ``--steps`` set to ``n_chunks`` chunks of its own shape
    (the preset applied, ``--chunks-per-dispatch`` included)."""
    from ..cli.parsing import apply_preset, prepare_parser

    args = prepare_parser().parse_args(argv)
    if args.preset:
        args = apply_preset(args, argv)
    steps = n_chunks * args.chunk_steps * args.n_envs * args.chunks_per_dispatch
    if "--steps" in argv:
        at = argv.index("--steps")
        argv = argv[:at] + argv[at + 2:]
    return argv + ["--steps", str(steps)]


def cli_run(argv, dev) -> dict:
    """One CLI run: its eval rows and the digests of its final checkpoint's
    leaves (learner state, engine lanes, generator)."""
    from ..cli.main import run
    from ..utils.meters import MetricsLogger

    argv = argv + ["--seed", str(SEED), "--platform", dev.type]
    rows, log = [], MetricsLogger.log

    def record(self, step, scalars, prefix="train"):
        if prefix == "eval":
            rows.append(row_digest({k: float(v) for k, v in scalars.items()}))
        return log(self, step, scalars, prefix)

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(MetricsLogger, "log", record), \
            contextlib.redirect_stdout(io.StringIO()):
        final = run(argv + ["--checkpoint-dir", tmp])
        leaves = ckpt.read(tmp, ckpt.latest_step(tmp))
    return {"final": final, "evals": rows,
            "state": {k: digest(v) for k, v in leaves.items()}}


def cnn_corners(engine: str, dev, n_chunks: int = CNN_CHUNKS) -> dict:
    """PPO-CNN on corners (``tools/agent_gates.py::_corners_cnn``'s recipe):
    ``array`` the base ``PPOTrainer``, ``mxu`` ``MXUPPOTrainer``; N = 64,
    T = 16, a greedy eval of 25 steps after each chunk."""
    from ..agents.ppo import PPOCNNAgent
    from ..envs import make_env
    from ..envs.array_vec import ArrayVecEnv
    from ..envs.vec import VecEnv
    from ..training import MXUPPOTrainer, PPOTrainer, stats_to_host

    if engine == "array":
        env = make_env("corners")
        vec, cls = ArrayVecEnv(env, 64, dev), PPOTrainer
    else:
        env = make_env("corners", compiled=True, device=dev)
        vec, cls = VecEnv(env, 64), MXUPPOTrainer
    tr = cls(PPOCNNAgent(env, lr=1e-3, entropy_bonus=0.05), vec)
    g = torch.Generator(device=dev).manual_seed(SEED)
    astate, vstate = tr.init(seed=SEED, generator=g)
    rows = []
    for _ in range(n_chunks):
        astate, vstate, _, loss = tr.train_chunk(astate, vstate, g, 16)
        _, es = tr.eval_chunk(astate, vec.reset(g), 25, generator=g)
        rows.append(row_digest({**stats_to_host(es), "loss": float(loss)}))
    return {"evals": rows, "state": tree_digests((astate, vstate, g))}


def paths() -> dict:
    """``name -> run(dev) -> {"evals", "state", ...}`` of every repeated path."""
    out = {name: (lambda d, a=argv: cli_run(cut(a, CHUNKS), d))
           for name, argv in CLI_PATHS.items()}
    out["PPOTrainer cnn corners"] = lambda d: cnn_corners("array", d)
    out["MXUPPOTrainer cnn corners"] = lambda d: cnn_corners("mxu", d)
    return out


def repeat(names, dev) -> list:
    """Each path twice; a record per path with the leaves and rows that
    differ between the two runs (none when it repeats)."""
    table, results = paths(), []
    for name in names:
        runs, walls = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append(table[name](dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        a, b = runs
        parted = sorted(k for k in set(a["state"]) | set(b["state"])
                        if a["state"].get(k) != b["state"].get(k))
        rows = [i for i, (x, y) in enumerate(zip(a["evals"], b["evals"])) if x != y]
        if len(a["evals"]) != len(b["evals"]):
            rows.append("count")
        results.append({"name": name, "leaves": len(a["state"]), "evals": len(a["evals"]),
                        "parted_leaves": parted, "parted_evals": rows,
                        "repeats": not parted and not rows and bool(a["state"]),
                        "wall_s": walls, "final": a.get("final")})
    return results


# ---- the CNN chunk's cost ---------------------------------------------------------------

def cnn_chunk_ms(dev, rounds: int = 3) -> dict:
    """CUDA-event ms of one ``train_chunk`` of ``shift ppo-cnn --preset
    --compiled --mxu`` (``MXUPPOTrainer``, N = 512, T = 32: the collect and
    4 epochs of 8 minibatches) with the convolutions on cuDNN's
    deterministic algorithms (``networks._fp32_convs``) and on the ones it
    picks by default (TF32 off, as before they were pinned), in rounds of
    default, deterministic, deterministic, default after one warm-up chunk
    each; the median and every time of each."""
    from ..agents import make_agent, networks
    from ..cli.main import _engine, _trainer
    from ..cli.parsing import agent_kwargs, apply_preset, prepare_parser
    from ..envs import make_env

    argv = ["shift", "ppo-cnn", "--preset", "--compiled", "--mxu"]
    args = apply_preset(prepare_parser().parse_args(argv), argv)
    env = make_env("shift", compiled=True, device=dev)
    tr = _trainer(args, make_agent(args.agent, env, **agent_kwargs(args)),
                  _engine(args, env, dev))
    g = torch.Generator(device=dev).manual_seed(SEED)
    state = list(tr.init(seed=SEED, generator=g))
    b = torch.backends.cudnn

    def default(x):
        return b.flags(enabled=b.enabled, benchmark=b.benchmark,
                       deterministic=b.deterministic, allow_tf32=False)

    flags = {"default": default, "deterministic": networks._fp32_convs}
    times = {k: [] for k in flags}

    def chunk(name):
        with mock.patch.object(networks, "_fp32_convs", flags[name]):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            state[:] = tr.train_chunk(state[0], state[1], g, args.chunk_steps)[:2]
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

    for name in flags:
        chunk(name)
    for _ in range(rounds):
        for name in ("default", "deterministic", "deterministic", "default"):
            times[name].append(chunk(name))
    return {k: {"median_ms": sorted(v)[len(v) // 2], "ms": v} for k, v in times.items()}


# ---- the probe ------------------------------------------------------------------------

def probe_runs() -> dict:
    """``name -> run(dev)`` of the probe: the CLI commands of
    ``chip_smoke.py`` phases 4, 6 and 7 cut to ``PROBE_CHUNKS`` chunks, phase
    7's trainer jobs (the DQN ones at 9 chunks, one eval) and phase 6's
    trainer runs on corners at a few chunks."""
    import chip_smoke as cs

    from . import agent_gates as ag

    cli = {"shift tabular-q --preset (fused)": ["shift", "tabular-q", "--compiled", "--mxu",
                                                "--fused-kernel", "--preset"],
           "sokoban deep-q (fused)": cs.DQN_MAIN, "island ppo-mlp --preset (fused)": cs.PPO_MAIN,
           "whisky deep-q (fused)": cs.DQN_STOCH_MAIN, "absent ppo-mlp (fused)": cs.PPO_STOCH_MAIN,
           "island ppo-mlp --n-hidden 256": cs.PPO_WIDE_MAIN,
           "boat ppo-mlp --preset": cs.BOAT_PPO, "conveyor ppo-mlp": cs.CONVEYOR_PPO,
           "corners ppo-crmdp --mxu": cs.CRMDP_MXU,
           "corners ppo-crmdp --fused-kernel": cs.CRMDP_FUSED,
           "tomato-crmdp ppo-crmdp --preset": cs.TOMATO_CRMDP,
           "conveyor deep-q": cs.CONVEYOR_DQN,
           "shift tabular-q --lr 0.2": cs.ARRAY_DEFAULT,
           "shift tabular-q --compiled --mxu": cs.MXU_TAB,
           "sokoban deep-q --n-envs 4096 --compiled": cs.SOKOBAN_DQN_4096}
    cli.update({f"sokoban deep-q {k}": v for k, v in cs.DQN_WIDE_MAIN.items()})
    cli.update({f"{a} tabular-q (fused)": [a] + cs.STOCH_TAB + flags
                for a, (flags, _) in cs.STOCH_MAIN.items()})
    cli.update({f"{a} tabular-q (fused suite)": [a] + cs.TAB_SUITE + ["--n-envs", str(n)]
                for a, (n, _, _) in cs.TAB_ROWS.items()})
    cli.update({f"{a} tabular-q (array suite)": [a] + cs.ARRAY_SUITE
                for a in (*cs.ARRAY_ROWS, "neutral")})
    cli.update({name: argv for name, argv in (
        (" ".join(ag.ABSENT_PER[:6]), ag.ABSENT_PER), (" ".join(ag.SHIFT_CNN), ag.SHIFT_CNN),
        (" ".join(ag.ISLAND_PARITY), ag.ISLAND_PARITY),
        (" ".join(ag.CORNERS_PARITY), ag.CORNERS_PARITY))})
    out = {name: (lambda d, a=argv: cli_run(cut(a, PROBE_CHUNKS), d))
           for name, argv in cli.items()}

    def job(name):
        def go(d):
            with mock.patch.object(ag, "DQN_CHUNKS", 9):
                return ag.JOBS[name][1](d)
        return go

    out.update({f"job {name}": job(name) for name in ag.JOBS if name not in CLI_JOBS})

    def corners(trainer_of):
        return lambda d: cs.corners_run(trainer_of, 4, SEED, d)

    from ..agents.crmdp import PPOCRMDPAgent
    from ..agents.ppo import PPOAgent
    from ..training import CRMDPTrainer, PPOTrainer

    out["PPOTrainer corners"] = corners(
        lambda e, v: PPOTrainer(PPOAgent(e, lr=1e-3, entropy_bonus=0.05), v))
    out["CRMDPTrainer corners"] = corners(lambda e, v: CRMDPTrainer(PPOCRMDPAgent(
        e, lr=1e-3, entropy_bonus=0.05, crmdp_lr=1.0), v))
    out["PPOTrainer(net='pallas') shift"] = lambda d: _pallas_ppo(d, cs)
    return out


def _pallas_ppo(dev, cs):
    """Phase 6's PPO with B11 on shift: a few chunks."""
    from ..agents.ppo import PPOAgent
    from ..envs import make_env
    from ..envs.array_vec import ArrayVecEnv
    from ..training import PPOTrainer

    shift = make_env("shift")
    tr = PPOTrainer(PPOAgent(shift, net="pallas", lr=5e-4, entropy_bonus=0.5),
                    ArrayVecEnv(shift, cs.PALLAS_N, dev))
    g = torch.Generator(device=dev).manual_seed(SEED)
    a, v = tr.init(seed=SEED, generator=g)
    for _ in range(2):
        a, v, _, _ = tr.train_chunk(a, v, g, cs.PALLAS_T)
    return {}


# aten ops whose kernels PyTorch's documentation of
# ``torch.use_deterministic_algorithms`` lists as nondeterministic on CUDA
# by default: those it swaps for a deterministic version in that mode
# (which then no longer warn) and those that warn or raise there.
WATCH = frozenset((
    "index_add", "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_put", "index_put_", "_index_put_impl_", "put", "put_",
    "index_copy", "index_copy_", "cumsum", "cumsum_", "convolution", "convolution_backward",
    "cudnn_convolution", "embedding_dense_backward", "_embedding_bag",
    "_embedding_bag_dense_backward", "bincount", "histc", "kthvalue", "median", "nanmedian",
    "multinomial", "nll_loss2d_forward", "_ctc_loss", "repeat_interleave",
    "grid_sampler_2d_backward", "adaptive_avg_pool2d_backward", "max_unpool2d"))
_PKG = Path(__file__).resolve().parents[1]


def _site() -> str:
    """The port's innermost frame below this tool on the calling stack, as
    ``file:line``; ``(autograd)`` for an op the backward pass runs."""
    for fr in reversed(traceback.extract_stack()):
        path = Path(fr.filename)
        if _PKG in path.parents and path.name != "repeat_cases.py":
            return f"{path.relative_to(_PKG.parent)}:{fr.lineno}"
    return "(autograd)"


class OpCensus(TorchDispatchMode):
    """Counts each call of a ``WATCH`` op by op, device, dtype, what decides
    its order (``accumulate`` of an indexed write, cuDNN's ``deterministic``
    flag of a convolution) and the port's calling line."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in WATCH and args and isinstance(args[0], torch.Tensor):
            x = args[0]
            how = ""
            if name in ("index_put", "index_put_", "_index_put_impl_", "put", "put_"):
                acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
                how = f" accumulate={bool(acc)}"
            elif name.startswith(("convolution", "cudnn_convolution")):
                how = f" cudnn.deterministic={torch.backends.cudnn.deterministic}"
            key = f"{name} {x.device.type} {str(x.dtype).replace('torch.', '')}{how} @ {_site()}"
            self.calls[key] = self.calls.get(key, 0) + 1
        return func(*args, **kwargs)


def probe(names, dev) -> dict:
    """Each probed run under PyTorch's deterministic algorithms (warn-only)
    and an ``OpCensus``: ``{"sites": {warning @ file:line: [runs]},
    "ops": {census key: {run: calls}}, "runs": {name: wall_s}, "errors":
    {name: error}}``."""
    table = probe_runs()
    sites, ops, walls, errors = {}, {}, {}, {}
    pkg = str(_PKG)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name in names:
            t0 = time.perf_counter()
            census = OpCensus()
            with warnings.catch_warnings(record=True) as caught, \
                    contextlib.redirect_stdout(io.StringIO()):
                warnings.simplefilter("always")
                try:
                    with census:
                        table[name](dev)
                except Exception as e:  # noqa: BLE001 (a run that fails is reported)
                    errors[name] = f"{type(e).__name__}: {e}"[:300]
            walls[name] = time.perf_counter() - t0
            for key, n in census.calls.items():
                ops.setdefault(key, {})[name] = n
            for w in caught:
                msg = str(w.message).split("\n")[0]
                if "determinis" not in msg.lower():
                    continue
                where = os.path.relpath(w.filename, os.path.dirname(pkg))
                key = f"{msg[:160]} @ {where}:{w.lineno}"
                sites.setdefault(key, [])
                if name not in sites[key]:
                    sites[key].append(name)
            print(f"probe {name}: {walls[name]:.2f} s", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    return {"sites": sites, "ops": ops, "runs": walls, "errors": errors}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--probe", action="store_true",
                   help="list the operations PyTorch's deterministic mode warns of")
    p.add_argument("--cnn-chunk", action="store_true",
                   help="time a shift ppo-cnn --preset chunk on both convolution algorithms")
    p.add_argument("--only", nargs="*", default=[], help="names starting with these")
    p.add_argument("--platform", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from ..device import resolve_device

    torch.set_num_threads(1)  # as tools/agent_gates.py: one CPU thread
    dev = resolve_device(args.platform)
    card = "cpu"
    if dev.type == "cuda":
        from .learner_cases import nvidia_smi

        card = nvidia_smi("name,power.limit")
        print(f"card {card}", flush=True)
    t0 = time.perf_counter()
    if args.cnn_chunk:
        summary = {"card": card, "cnn_chunk": cnn_chunk_ms(dev)}
        print(f"shift ppo-cnn --preset chunk: {json.dumps(summary['cnn_chunk'])} on {card}",
              flush=True)
        ok = True
    elif args.probe:
        names = [n for n in probe_runs() if not args.only
                 or any(n.startswith(o) for o in args.only)]
        summary = {"card": card, "probe": probe(names, dev)}
        for site, runs in summary["probe"]["sites"].items():
            print(f"warning {site}: {len(runs)} runs ({', '.join(runs[:4])}"
                  f"{', ...' if len(runs) > 4 else ''})", flush=True)
        for key, runs in sorted(summary["probe"]["ops"].items()):
            print(f"op {key}: {sum(runs.values())} calls in {len(runs)} runs "
                  f"({', '.join(list(runs)[:3])}{', ...' if len(runs) > 3 else ''})",
                  flush=True)
        ok = not summary["probe"]["errors"]
    else:
        names = [n for n in paths() if not args.only or any(n.startswith(o) for o in args.only)]
        results = repeat(names, dev)
        for r in results:
            print(f"{r['name']}: {'repeats' if r['repeats'] else 'PARTED'} ({r['leaves']} "
                  f"leaves, {r['evals']} eval rows; parted: {r['parted_leaves'][:6]} "
                  f"{r['parted_evals']}); runs {r['wall_s'][0]:.2f} s, {r['wall_s'][1]:.2f} s "
                  f"on {card}", flush=True)
        summary = {"card": card, "seed": SEED, "results": results}
        ok = all(r["repeats"] for r in results)
    summary["wall_s"] = time.perf_counter() - t0
    line = json.dumps(summary, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
