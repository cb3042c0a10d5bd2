"""``chip_smoke.py`` phase 11: the port's tools on the card, each in a fresh
process with the kernels' launch counts set to 0 before it and read after
it (``tools/counted.py``).

    python -m safe_grid_agents_torch.tools.tool_cases [--platform cpu] [--out FILE]

Parts, at the card's sizes (toy sizes with ``--platform cpu``):

* ``sweep`` ``seed=0,1`` over ``shift tabular-q --compiled --mxu
  --fused-kernel --preset`` (B2): two rows, each ≥ 38 (optimum 40);
* ``tune``: 3 samples × 2 rungs of 16,384 steps and a final gate of 2 on
  the same command (``tests/test_tools.py:56, :87``'s flags): the rung-0
  rows, the promotion at 32,768 steps resumed from its checkpoint, the
  finals at 65,536 and the winner by the final eval;
* ``suite tabular-q`` on shift, island, boat, absent, whisky and tomato
  with ``--extra --compiled --mxu --fused-kernel`` (B2, B8): one row each;
* ``fuzz`` at 4096 lanes × 256 steps on every compileable alias
  (1,048,576 transitions an alias; the friend family's ``4 · cap`` window
  is 508 steps at cap 127, so it is not cut);
* ``curves --seeds 0 --check``: each config's seed-0 curve within the
  reference's stored seed band ± 5;
* ``scale`` of tabular and dqn at 1 (NCCL) and 2 (gloo ranks sharing the
  card) devices: counted all-reduce bytes against the analytic model;
* ``quickstart``: sokoban's DOWN episode −100/−110, shift trained to 40;
* ``diag`` ``engine-pallas`` (4096 lanes, T = 4096: B1), ``engine-stoch``
  (T = 1024 on absent, interrupt, whisky and friend at cap 15: B7), ``ppo-decomp`` (the island preset's N = 1024, T = 64:
  B5, B6), ``dqn-decomp`` (the sokoban command's N = 128, T = 32: B3, B4)
  and ``ppo-kernel-opt`` (N = 1024, T = 64: B6), one process, started
  with the others but timing only once they have ended, so that no other
  job shares the card while it times.

The parts before ``diag`` run at once, each in its own process (the card
is idle most of their time); a part that fails raises ``AssertionError``
with the tail of its output. Returns the summary: each part's wall time,
its launches by kernel, its checks and ``diag``'s rows.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TAB = ["--compiled", "--mxu", "--fused-kernel"]
TUNE = ["shift", "tabular-q", "--samples", "3", "--rungs", "2", "--eta", "2",
        "--rung-steps", "16384", "--space", "lr=0.05,0.2,0.5", "--final-gate", "2",
        "--n-envs", "64", "--chunk-steps", "64", "--eval-every", "1000",
        "--eval-steps", "30", "--epsilon-anneal-steps", "8000"] + TAB
SUITE_ALIASES = "shift,island,boat,absent,whisky,tomato"
DIAG_CARD = {
    "engine-pallas": ["--lanes", "4096", "--t", "4096"],
    "engine-stoch": ["--lanes", "4096", "--t", "1024", "--aliases", "absent", "interrupt",
                     "whisky", "friend"],
    "ppo-decomp": ["--n-envs", "1024", "--t", "64"],
    "dqn-decomp": ["--n-envs", "128", "--t", "32"],
    "ppo-kernel-opt": ["--n-envs", "1024", "--t", "64"],
}
# The kernels each diag subcommand must launch on the card.
DIAG_KERNELS = {
    "engine-pallas": ("rollout",),
    "engine-stoch": ("stoch_rollout",),
    "ppo-decomp": ("ppo_collect", "ppo_optimize"),
    "dqn-decomp": ("dqn_collect",),
    "ppo-kernel-opt": ("ppo_optimize",),
}


def parts(platform: str, work: str) -> dict:
    """``{part: [(module, args), ...]}``: the counted groups of each part."""
    card = platform == "cuda"
    P = ["--platform", platform]
    diag = []
    for cmd, sizes in DIAG_CARD.items():
        diag.append(("tools.diag", [cmd] + (sizes if card else []) + P
                     + ["--out", os.path.join(work, f"diag_{cmd}.json")]))
    return {
        "sweep": [("tools.sweep", ["shift", "tabular-q", "--preset"] + TAB + P
                   + ["--sweep", "seed=0,1"])],
        "tune": [("tools.tune", TUNE + P + ["--work-dir", os.path.join(work, "tune")])],
        "suite": [("tools.suite", ["tabular-q", "--envs", SUITE_ALIASES]
                   + ([] if card else ["--steps", "16384"]) + P + ["--extra"] + TAB)],
        "fuzz": [("tools.fuzz", (["--steps", "256", "--n-envs", "4096"] if card
                                 else ["--steps", "64", "--n-envs", "32"]) + P)],
        "curves": [("tools.curves", ["--seeds", "0", "--check"] + P)],
        "scale": [("tools.scale", ["--families", "tabular,dqn", "--devices", "1,2",
                                   "--json", "-q"] + P)],
        "quickstart": [("examples.quickstart", P)],
        "diag": diag,
    }


def _start(name: str, groups, work: str, after: str | None = None):
    cmd = [sys.executable, "-m", "safe_grid_agents_torch.tools.counted",
           "--out", os.path.join(work, f"{name}.counted.json")]
    cmd += (["--after", after] if after else []) + ["--"]
    for i, (module, args) in enumerate(groups):
        cmd += (["---"] if i else []) + [module] + list(args)
    log_path = os.path.join(work, f"{name}.log")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    f = open(log_path, "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                            text=True)
    return proc, f, log_path, time.perf_counter()


def _finish_all(started: dict, timeout: float) -> dict:
    """Wait for every started part (polling, so that each part's wall time
    ends when it does); a part past ``timeout`` is killed."""
    ends, deadline = {}, time.perf_counter() + timeout
    while len(ends) < len(started):
        for name, (proc, *_rest) in started.items():
            if name not in ends and proc.poll() is not None:
                ends[name] = time.perf_counter()
        if time.perf_counter() > deadline:
            for name, (proc, *_rest) in started.items():
                if name not in ends:
                    proc.kill()
                    proc.wait()
                    ends[name] = time.perf_counter()
        time.sleep(0.1)
    return {name: _finish(name, s, ends[name]) for name, s in started.items()}


def _finish(name, started, end: float) -> dict:
    proc, f, log_path, t0 = started
    f.close()
    text = Path(log_path).read_text()
    counted = [json.loads(l[len("counted: "):]) for l in text.splitlines()
               if l.startswith("counted: ")]
    assert proc.returncode == 0, f"phase 11 {name}: exit {proc.returncode}\n{text[-3000:]}"
    return {"wall_s": end - t0, "counted": counted, "log": text}


def _json_lines(text: str) -> list:
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def check(name: str, res: dict, platform: str, work: str) -> dict:
    """The part's checks on its output; raises ``AssertionError``."""
    text, counted = res["log"], res["counted"]
    launches = {}
    for c in counted:
        for k, n in c["launches"].items():
            launches[k] = launches.get(k, 0) + n
    card = platform == "cuda"
    plain = {k: n for c in counted for k, n in c["plain_calls"].items()}
    if card:
        assert not plain, f"phase 11 {name}: plain versions ran on the card: {plain}"
    out = {"wall_s": res["wall_s"], "launches": launches,
           "inner_wall_s": [c["wall_s"] for c in counted]}
    lines = _json_lines(text)
    if name == "sweep":
        assert [r["seed"] for r in lines] == ["0", "1"], lines
        assert all(r["mean_return"] is not None and r["mean_return"] >= 38 for r in lines), lines
        assert "best by mean_return:" in text
        out["rows"] = lines
        want = ("tabq",)
    elif name == "tune":
        rung0 = [r for r in lines if r.get("rung") == 0]
        rung1 = [r for r in lines if r.get("rung") == 1]
        finals = [r for r in lines if r.get("rung") == "final"]
        assert len(rung0) == 3 and len(rung1) == 1 and rung1[0]["steps"] == 32768, lines
        assert "resumed from chunk" in text, "tune: promotion did not resume"
        assert len(finals) == 2 and finals[0]["steps"] == 16384 * 4, lines
        best = max(finals, key=lambda r: r["mean_return"])
        assert "winner" in lines[-1] and lines[-1]["winner"] == best["cfg"], lines
        out["winner"] = lines[-1]
        want = ("tabq",)
    elif name == "suite":
        envs = [r["env"] for r in lines]
        assert envs == SUITE_ALIASES.split(","), envs
        out["rows"] = lines
        want = ("tabq", "tabq_stoch")
    elif name == "fuzz":
        oks = [l for l in text.splitlines() if " OK  (" in l]
        assert len(oks) == 19 and "all 19 aliases bitwise-identical" in text, text[-2000:]
        per = [int(l.split("(")[1].split()[0].replace(",", "")) for l in oks]
        if card:
            assert min(per) >= 1 << 20, per
        out["transitions"] = sum(per)
        want = ()
    elif name == "curves":
        out["band_checks"] = [l.strip() for l in text.splitlines() if "reference's band" in l]
        assert len(out["band_checks"]) == 3, text[-2000:]
        want = ()
    elif name == "scale":
        assert [(r["family"], r["devices"]) for r in lines] == [
            ("tabular", 1), ("tabular", 2), ("dqn", 1), ("dqn", 2)], lines
        out["rows"] = [{k: r[k] for k in ("family", "devices", "allreduce_calls",
                                          "allreduce_counted_bytes", "backend",
                                          "chunk_wall_s")} for r in lines]
        want = ()
    elif name == "quickstart":
        assert "gym-style episode: -100.0 hidden: -110.0" in text, text[-2000:]
        ev = [l for l in text.splitlines() if l.startswith("trained eval:")]
        assert ev and "'mean_return': 40.0" in ev[0], ev
        out["lines"] = [l for l in text.splitlines()
                        if l.startswith(("vectorized:", "trained eval:", "fused rollout",
                                         "  "))]
        want = ("rollout",)
    else:  # diag
        out["subcommands"] = {}
        for c in counted:
            cmd = c["args"][0]
            rows = json.loads(Path(work, f"diag_{cmd}.json").read_text())["rows"]
            checks = [r for r in rows if "check" in r]
            assert all(r["equal"] for r in checks), (cmd, checks)
            if cmd in ("engine-pallas", "engine-stoch", "ppo-kernel-opt"):
                assert checks, (cmd, rows)
            if card:
                for k in DIAG_KERNELS[cmd]:
                    assert c["launches"].get(k, 0) > 0, (cmd, k, c["launches"])
            out["subcommands"][cmd] = {"launches": c["launches"], "wall_s": c["wall_s"],
                                       "rows": rows}
        want = ()
    if card:
        for k in want:
            assert launches.get(k, 0) > 0, f"phase 11 {name}: {k} never launched: {launches}"
    return out


def card_phase(platform: str = "cuda", log=print, timeout: float = 600.0) -> dict:
    """Phase 11 (module doc); returns the summary, raises at a fault."""
    t0 = time.perf_counter()
    if platform == "cuda":
        # Every kernel built before the parts start (chip_smoke.py phase 1 has
        # built them; alone, this builds them once, not once a process).
        from ..ops import _build

        _build.build(*sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    with tempfile.TemporaryDirectory(prefix="sga_phase11_") as work:
        todo = parts(platform, work)
        # diag starts with the others and waits (imported, on the card) for
        # them to end before it times anything.
        wave_done = os.path.join(work, "wave_done")
        diag = _start("diag", todo["diag"], work, after=wave_done)
        results = _finish_all({n: _start(n, g, work) for n, g in todo.items()
                               if n != "diag"}, timeout)
        t_wave = time.perf_counter() - t0
        Path(wave_done).touch()
        summary = {n: check(n, r, platform, work) for n, r in results.items()}
        summary["diag"] = check("diag", _finish_all({"diag": diag}, timeout)["diag"], platform,
                                work)
    for n, s in summary.items():
        log(f"11. {n}: {s['wall_s']:.1f} s, launches {json.dumps(s['launches'])}")
    for cmd, s in summary["diag"]["subcommands"].items():
        for r in s["rows"]:
            if "label" in r:
                log(f"11. diag {cmd}: {r['label']}: {r['ms']:.4f} ms")
    summary["_parallel_wave_s"] = t_wave
    summary["_wall_s"] = time.perf_counter() - t0
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    summary = card_phase(args.platform)
    print("phase 11 summary: " + json.dumps({k: (v if k.startswith("_") else
                                                 {kk: vv for kk, vv in v.items()
                                                  if kk != "subcommands"})
                                             for k, v in summary.items()}))
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
