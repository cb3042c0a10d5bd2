"""Resume, kill, profile and ``--debug-nans`` gates of the CLI.
``chip_smoke.py`` phase 8 runs them on the card; alone (``--platform cpu``
for a CPU run):

    python -m safe_grid_agents_torch.tools.resume_gates [--platform cpu]
        [--only twins sigkill profile debug-nans save-cost] [--out FILE]

* ``twins``: for each flag set of ``TWINS`` (the reference's five
  ``_resume_twin`` legs, ``tests/test_cli.py:159-220``, the stochastic
  fused tabular run on whisky and PER on the fused DQN trainer), a straight
  run and a half run resumed to the same length; their final checkpoints
  must be equal leaf by leaf, bitwise. Each run's kernel launches (plain
  calls on the CPU) are counted from 0 and must be ``EXPECT``'s kernels,
  the straight run's counts the half run's plus the resumed run's.
* ``sigkill``: ``tests/test_fault_tolerance.py:89`` on ``KILL_CONFIGS``: a
  CLI process killed with SIGKILL once a step at or past the kill point is
  committed, relaunched with ``--resume``, ends in the uninterrupted run's
  final state, bitwise.
* ``profile``: ``--profile-dir`` on the shift preset's fused tabular
  command, in a fresh process; the trace must hold events, and on the card
  kernel B2 (``tabq_kernel``) by name.
* ``debug-nans``: the shift preset with and without ``--debug-nans``: the
  same final eval and final checkpoint.
* ``save-cost``: the checkpoint at the fused DQN twin's flags after warmup
  and one chunk: its file size, the time ``save(wait=False)`` takes to
  return (the snapshot) and a synchronous save's.

Every part prints its wall time; the last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..utils import checkpoint as ckpt
from .agent_gates import all_counts

REPO = Path(__file__).resolve().parents[2]

FUSED_DQN = ["sokoban", "deep-q", "--compiled", "--mxu", "--fused-kernel",
             "--n-envs", "32", "--chunk-steps", "16", "--batch-size", "64",
             "--replay-capacity", "2048", "--sync-every", "10", "--warmup-steps", "16"]
# name -> (flags, full steps, half steps, chunks of the full run). The
# stochastic tabular kernel B8 takes chunk lengths that are multiples of 32.
TWINS = {
    "mxu ppo": (["corners", "ppo-mlp", "--compiled", "--mxu", "--table-net",
                 "--n-envs", "32", "--chunk-steps", "16", "--lr", "0.001",
                 "--entropy-bonus", "0.05"], 16384, 8192, 32),
    "fused tabular": (["corners", "tabular-q", "--compiled", "--mxu", "--fused-kernel",
                       "--n-envs", "32", "--chunk-steps", "16", "--lr", "0.2"],
                      16384, 8192, 32),
    "fused dqn": (FUSED_DQN, 16384, 8192, 32),
    "fused ppo": (["corners", "ppo-mlp", "--compiled", "--mxu", "--table-net",
                   "--fused-kernel", "--n-envs", "32", "--chunk-steps", "16",
                   "--lr", "0.001", "--entropy-bonus", "0.05"], 16384, 8192, 32),
    "mxu dqn": (["sokoban", "deep-q", "--compiled", "--mxu", "--n-envs", "32",
                 "--chunk-steps", "16", "--batch-size", "64", "--replay-capacity", "2048",
                 "--sync-every", "10", "--warmup-steps", "8"], 16384, 8192, 32),
    "whisky fused tabular": (["whisky", "tabular-q", "--compiled", "--mxu",
                              "--fused-kernel", "--n-envs", "32", "--chunk-steps", "32",
                              "--lr", "0.2"], 16384, 8192, 16),
    "fused dqn per": (FUSED_DQN + ["--prioritized"], 16384, 8192, 32),
}
# The kernels each twin runs (under the names of chip_smoke.py's kernels
# line); the MXU trainers run none.
EXPECT = {
    "mxu ppo": (),
    "fused tabular": ("tabq",),
    "fused dqn": ("dqn_collect", "dqn_update"),
    "fused ppo": ("ppo_collect", "ppo_optimize"),
    "mxu dqn": (),
    "whisky fused tabular": ("tabq_stoch",),
    "fused dqn per": ("dqn_collect",),
}

# name -> (flags without --steps/--checkpoint-dir, chunks, kill point,
# env steps a chunk): the reference's two configs
# (tests/test_fault_tolerance.py:35-56) and the fused tabular path, long
# enough on the card that the kill lands mid-run.
KILL_CONFIGS = {
    "tabular": (["shift", "tabular-q", "--n-envs", "1024", "--chunk-steps", "64",
                 "--eval-every", "100000", "--eval-steps", "8", "--lr", "0.2",
                 "--seed", "7", "--checkpoint-every", "20"], 400, 100, 64 * 1024),
    "ppo-mxu": (["corners", "ppo-mlp", "--compiled", "--mxu", "--table-net",
                 "--n-envs", "256", "--chunk-steps", "16", "--eval-every", "100000",
                 "--eval-steps", "8", "--lr", "0.001", "--seed", "7",
                 "--checkpoint-every", "10"], 300, 60, 16 * 256),
    "fused tabular": (["shift", "tabular-q", "--compiled", "--mxu", "--fused-kernel",
                       "--n-envs", "1024", "--chunk-steps", "256", "--eval-every", "100000",
                       "--eval-steps", "8", "--lr", "0.2", "--seed", "7",
                       "--checkpoint-every", "20"], 2000, 100, 256 * 1024),
}
PRESET = ["shift", "tabular-q", "--compiled", "--mxu", "--fused-kernel", "--preset"]
B2_KERNEL = "tabq_kernel"


def _counts():
    counts = all_counts()
    for c in counts.values():
        c.reset()
    return counts


def _launched(counts, device: str) -> dict:
    """Non-zero launches on the card, plain-version calls on the CPU."""
    key = "launches" if device.startswith("cuda") else "plain_calls"
    return {k: getattr(c, key) for k, c in counts.items() if getattr(c, key)}


def _quiet_run(argv):
    from ..cli.main import run

    with contextlib.redirect_stdout(io.StringIO()) as out:
        final = run(argv)
    return final, out.getvalue()


def assert_same_leaves(a: dict, b: dict, what: str) -> int:
    """Every leaf of two raw checkpoints (``checkpoint.read``) equal, dtypes
    included; returns the number of leaves."""
    assert a.keys() == b.keys(), (what, sorted(set(a) ^ set(b)))
    assert a, f"{what}: empty checkpoint"
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {k} differs"
        else:
            assert x == y, f"{what}: leaf {k}: {x!r} != {y!r}"
    return len(a)


def resume_twin(name: str, workdir, platform: str) -> dict:
    """A straight run and a half run resumed to the same length; raises
    ``AssertionError`` unless their final checkpoints, final evals and
    launches agree. ``--eval-every 1`` makes both draw the same evals from
    the run's generator."""
    flags, full, half, n_chunks = TWINS[name]
    workdir = Path(workdir)
    common = flags + ["--eval-every", "1", "--eval-steps", "8", "--checkpoint-every", "4",
                      "--seed", "7", "--platform", platform]
    runs = {"straight": (full, workdir / "straight", []),
            "half": (half, workdir / "resumed", []),
            "resumed": (full, workdir / "resumed", ["--resume"])}
    out = {"launches": {}, "wall_s": {}, "final": {}}
    for run_name, (steps, ckdir, extra) in runs.items():
        counts = _counts()
        t0 = time.perf_counter()
        final, text = _quiet_run(common + ["--steps", str(steps), "--checkpoint-dir",
                                           str(ckdir)] + extra)
        if platform != "cpu":
            torch.cuda.synchronize()
        out["wall_s"][run_name] = time.perf_counter() - t0
        out["launches"][run_name] = _launched(counts, platform)
        out["final"][run_name] = final
        assert ("resumed from chunk" in text) == bool(extra), (name, run_name)
    assert ckpt.latest_step(workdir / "resumed") == n_chunks, name
    out["leaves"] = assert_same_leaves(ckpt.read(workdir / "straight", n_chunks),
                                       ckpt.read(workdir / "resumed", n_chunks), name)
    assert json.dumps(out["final"]["straight"]) == json.dumps(out["final"]["resumed"]), name
    lc = out["launches"]
    assert set(lc["straight"]) == set(EXPECT[name]), (name, lc)
    for k in EXPECT[name]:
        assert lc["straight"][k] == lc["half"][k] + lc["resumed"][k] > 0, (name, k, lc)
    out["bytes"] = os.path.getsize(workdir / "straight" / str(n_chunks) / ckpt.FILE)
    return out


def _kill_argv(name: str, ckdir, platform: str):
    argv, n_chunks, _, steps_per_chunk = KILL_CONFIGS[name]
    return [sys.executable, "-m", "safe_grid_agents_torch", *argv, "--platform", platform,
            "--steps", str(n_chunks * steps_per_chunk), "--checkpoint-dir", str(ckdir)]


def sigkill_twin(name: str, workdir, platform: str, timeout: float = 600.0) -> dict:
    """``tests/test_fault_tolerance.py:89``: an uninterrupted process, then one
    killed with SIGKILL once a step at or past the kill point is committed
    (possibly mid-write of a later step) and relaunched with ``--resume``;
    the final checkpoints must be bitwise equal."""
    _, n_chunks, kill_at, _ = KILL_CONFIGS[name]
    workdir = Path(workdir)
    dir_a, dir_b = workdir / "uninterrupted", workdir / "preempted"
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    t0 = time.perf_counter()
    subprocess.run(_kill_argv(name, dir_a, platform), cwd=REPO, env=env, check=True,
                   capture_output=True, timeout=timeout)
    wall_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.Popen(_kill_argv(name, dir_b, platform), cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + timeout
        while time.time() < deadline:
            steps = ckpt.committed_steps(str(dir_b))
            if steps and steps[-1] >= kill_at:
                break
            if proc.poll() is not None:
                raise AssertionError(f"{name}: the run ended before the kill point:\n"
                                     + proc.stdout.read().decode()[-4000:])
            time.sleep(0.02)
        assert proc.poll() is None, f"{name}: no step reached {kill_at} in {timeout} s"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    killed_at = ckpt.committed_steps(str(dir_b))[-1]
    assert kill_at <= killed_at < n_chunks, (name, killed_at)
    out = subprocess.run(_kill_argv(name, dir_b, platform) + ["--resume"], cwd=REPO,
                         env=env, check=True, capture_output=True, timeout=timeout)
    wall_b = time.perf_counter() - t0
    assert b"resumed from chunk" in out.stdout, out.stdout[-2000:]
    leaves = assert_same_leaves(ckpt.read(dir_a, n_chunks), ckpt.read(dir_b, n_chunks),
                                f"sigkill {name}")
    return {"killed_at": killed_at, "kill_at": kill_at, "chunks": n_chunks,
            "leaves": leaves, "wall_s": {"uninterrupted": wall_a, "killed_and_resumed": wall_b}}


def profile_run(workdir, platform: str, timeout: float = 600.0) -> dict:
    """``--profile-dir`` on the shift preset in a fresh process: one Chrome
    trace with events; on the card B2's kernel among them."""
    trace = Path(workdir) / "trace"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "safe_grid_agents_torch", *PRESET,
                    "--platform", platform, "--profile-dir", str(trace)], cwd=REPO,
                   check=True, capture_output=True, timeout=timeout)
    wall = time.perf_counter() - t0
    files = sorted(os.listdir(trace))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
    events = json.loads((trace / files[0]).read_text())["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    b2 = [k for k in kernels if B2_KERNEL in k]
    assert events, "empty trace"
    if platform != "cpu":
        assert b2, f"no {B2_KERNEL} among the trace's kernels: {kernels[:20]}"
    return {"file": files[0], "events": len(events), "kernels": len(kernels),
            "b2_events": sum(1 for e in events if e.get("cat") == "kernel"
                             and B2_KERNEL in e["name"]),
            "b2_names": b2, "wall_s": wall}


def debug_nans_run(workdir, platform: str) -> dict:
    """The shift preset with and without ``--debug-nans``: the same final
    eval and the same final checkpoint."""
    out = {}
    for flag in (False, True):
        ckdir = Path(workdir) / ("flag" if flag else "plain")
        t0 = time.perf_counter()
        final, _ = _quiet_run(PRESET + ["--platform", platform, "--checkpoint-dir",
                                        str(ckdir)] + (["--debug-nans"] if flag else []))
        out["debug_nans" if flag else "plain"] = {"final": final,
                                                  "wall_s": time.perf_counter() - t0}
    assert json.dumps(out["plain"]["final"]) == json.dumps(out["debug_nans"]["final"]), out
    step = ckpt.latest_step(Path(workdir) / "plain")
    assert_same_leaves(ckpt.read(Path(workdir) / "plain", step),
                       ckpt.read(Path(workdir) / "flag", step), "--debug-nans")
    return out


def save_cost(workdir, platform: str, reps: int = 5) -> dict:
    """The fused DQN twin's state after warmup and one chunk: the size of
    its checkpoint file, the host ms ``save(wait=False)`` takes to return
    (the copy to the host) and the ms of a save that waits for the file
    (medians of ``reps``)."""
    import statistics

    from ..device import resolve_device
    from .learner_cases import cli_trainer

    dev = resolve_device(platform)
    tr, args = cli_trainer(FUSED_DQN + ["--prioritized"], dev)
    g = torch.Generator(device=dev).manual_seed(7)
    astate, vstate = tr.init(seed=7, generator=g)
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, args.warmup_steps)
    astate, vstate = tr.train_chunk(astate, vstate, g, args.chunk_steps)[:2]
    state = (astate, vstate, g)
    snap, full = [], []
    for i in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(Path(workdir) / "async", i, state, wait=False)
        snap.append((time.perf_counter() - t0) * 1e3)
        ckpt.wait_all()
        t0 = time.perf_counter()
        ckpt.save(Path(workdir) / "sync", i, state)
        full.append((time.perf_counter() - t0) * 1e3)
    size = os.path.getsize(Path(workdir) / "sync" / str(reps - 1) / ckpt.FILE)
    return {"bytes": size, "snapshot_ms": statistics.median(snap),
            "save_ms": statistics.median(full), "reps": reps}


PARTS = ("twins", "sigkill", "profile", "debug-nans", "save-cost")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--platform", default="cuda")
    p.add_argument("--only", nargs="*", default=list(PARTS), choices=PARTS)
    p.add_argument("--twins", nargs="*", default=list(TWINS), choices=list(TWINS))
    p.add_argument("--kill", nargs="*", default=None, choices=list(KILL_CONFIGS),
                   help="kill configs (default: fused tabular on the card, tabular on "
                        "the CPU)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.platform)
    platform = dev.type
    card = "cpu"
    if dev.type == "cuda":
        from ..ops import _build
        from .learner_cases import nvidia_smi

        _build.build("tabular_kernel", "tabular_stoch_kernel", "dqn_kernel",
                     "dqn_update_kernel", "ppo_collect_kernel", "ppo_kernel")
        card = nvidia_smi("name,power.limit")
        print(f"card {card}", flush=True)
    kill = args.kill or (["fused tabular"] if platform == "cuda" else ["tabular"])
    summary = {"card": card, "platform": platform}
    with tempfile.TemporaryDirectory() as tmp:
        t_all = time.perf_counter()
        if "twins" in args.only:
            summary["twins"] = {}
            for name in args.twins:
                r = resume_twin(name, Path(tmp) / "twin" / name, platform)
                summary["twins"][name] = r
                print(f"twin {name}: {r['leaves']} leaves bitwise equal; wall "
                      f"{json.dumps({k: round(v, 3) for k, v in r['wall_s'].items()})} s "
                      f"on {card}; launches {json.dumps(r['launches'])}; final "
                      f"{json.dumps(r['final']['resumed'])}", flush=True)
        if "sigkill" in args.only:
            summary["sigkill"] = {}
            for name in kill:
                r = sigkill_twin(name, Path(tmp) / "kill" / name, platform)
                summary["sigkill"][name] = r
                print(f"sigkill {name}: killed with step {r['killed_at']} committed "
                      f"(kill point {r['kill_at']} of {r['chunks']}), resumed, "
                      f"{r['leaves']} leaves bitwise equal; wall {r['wall_s']} s on {card}",
                      flush=True)
        if "profile" in args.only:
            r = profile_run(Path(tmp) / "profile", platform)
            summary["profile"] = r
            print(f"profile: {r['events']} events, {r['kernels']} kernel names, "
                  f"{r['b2_events']} of {B2_KERNEL} ({r['b2_names']}); wall "
                  f"{r['wall_s']:.3f} s on {card}", flush=True)
        if "debug-nans" in args.only:
            r = debug_nans_run(Path(tmp) / "nans", platform)
            summary["debug_nans"] = r
            print(f"debug-nans: final eval {json.dumps(r['debug_nans']['final'])} with the "
                  f"flag, the same without; wall {r['debug_nans']['wall_s']:.3f} s "
                  f"(without {r['plain']['wall_s']:.3f} s) on {card}", flush=True)
        if "save-cost" in args.only:
            r = save_cost(Path(tmp) / "cost", platform)
            summary["save_cost"] = r
            print(f"save cost at the fused DQN twin's flags with PER: {r['bytes']} bytes, "
                  f"save(wait=False) returns in {r['snapshot_ms']:.3f} ms, a save that "
                  f"waits {r['save_ms']:.3f} ms on {card}", flush=True)
        summary["wall_s"] = time.perf_counter() - t_all
    line = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
