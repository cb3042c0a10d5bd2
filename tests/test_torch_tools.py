"""The port's CLI drivers (``safe_grid_agents_torch/tools/{sweep,tune,suite}
.py``) on the CPU: the twins of ``tests/test_tools.py:38, :56, :87`` with
the reference's assertions (as subprocesses, ``--platform cpu`` in place of
``SGA_PLATFORM=cpu``), the tuner's sampling against the reference's
``parse_space`` + ``random.Random`` for the same seed and space, a suite
run of three aliases, and every tool's refusal to fall back to the CPU."""
import ast
import json
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from safe_grid_agents_torch.tools import tune
from safe_grid_agents_torch.tools.suite import main as suite_main

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TUNE = ["shift", "tabular-q", "--samples", "3", "--rungs", "2", "--eta", "2",
        "--rung-steps", "16384", "--space", "lr=0.05,0.2,0.5"]
TUNE_BASE = ["--n-envs", "64", "--chunk-steps", "64", "--eval-every", "1000",
             "--eval-steps", "30", "--epsilon-anneal-steps", "8000", "--platform", "cpu"]


def _tool(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", f"safe_grid_agents_torch.tools.{name}",
                           *args], capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env=env)


def test_sweep_cli():
    out = _tool("sweep", "shift", "tabular-q", "--n-envs", "32", "--steps", "8192",
                "--chunk-steps", "128", "--eval-every", "100", "--eval-steps", "10",
                "--sweep", "seed=0,1", "--platform", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 2
    assert {json.loads(l)["seed"] for l in lines} == {"0", "1"}
    assert "best by mean_return:" in out.stdout.splitlines()[-1]


def test_tune_asha_cli(tmp_path):
    # 3 sampled configs, 2 rungs, the survivor RESUMES from its rung-1
    # checkpoint.
    out = _tool("tune", *TUNE, "--work-dir", str(tmp_path / "tune"), *TUNE_BASE)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    rung0 = [l for l in lines if l.get("rung") == 0]
    rung1 = [l for l in lines if l.get("rung") == 1]
    assert len(rung0) == 3, lines
    assert len(rung1) == 1, lines          # top 1/eta promoted
    assert rung1[0]["steps"] == 32768      # eta× longer budget
    assert "resumed from chunk" in out.stdout  # promotion resumed, not re-ran
    winner = lines[-1]
    assert "winner" in winner and "lr" in winner


def test_tune_final_gate_cli(tmp_path):
    # --final-gate K: the top-K resume to a budget beyond the last rung and
    # the winner is picked by THAT eval.
    out = _tool("tune", *TUNE, "--final-gate", "2", "--work-dir", str(tmp_path / "tune"),
                *TUNE_BASE)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    finals = [l for l in lines if l.get("rung") == "final"]
    assert len(finals) == 2, lines                 # top-2 re-scored
    assert finals[0]["steps"] == 16384 * 4         # one rung past the last
    winner = lines[-1]
    assert "winner" in winner
    best_final = max(finals, key=lambda l: l["mean_return"])
    assert winner["winner"] == best_final["cfg"]   # gated on the FINAL eval


def _reference_parse_space():
    """``parse_space`` of the repo's ``tools/tune.py``, compiled from its
    source alone (the module imports the JAX package)."""
    tree = ast.parse((ROOT / "tools" / "tune.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "parse_space")
    ns = {"math": math}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "tools/tune.py", "exec"), ns)
    return ns["parse_space"]


@pytest.mark.parametrize("seed,space", [
    (0, ["lr=0.05,0.2,0.5"]),
    (3, ["lr=log:1e-4:1e-2", "clipping=0.1,0.2,0.3"]),
    (11, ["entropy-bonus=0.0,0.01", "lr=log:1e-5:1e-3", "n-hidden=64,128,256"]),
])
def test_tune_samples_the_reference_configs(seed, space):
    parse_space = _reference_parse_space()
    rng = random.Random(seed)
    ref = [{name: sample(rng) for name, sample in parse_space(space).items()}
           for _ in range(8)]
    assert tune.sample_configs(space, 8, seed) == ref


def test_suite_prints_one_row_per_alias(capsys):
    rows = suite_main(["tabular-q", "--envs", "shift,island,boat", "--steps", "4096",
                       "--n-envs", "32", "--platform", "cpu"])
    out = capsys.readouterr().out
    assert [r["env"] for r in rows] == ["shift", "island", "boat"]
    printed = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    assert printed == rows
    table = out.split("\nenv ")[1].splitlines()[1:]
    assert [l.split()[0] for l in table] == ["shift", "island", "boat"]


@pytest.mark.parametrize("module,argv", [
    ("sweep", ["shift", "tabular-q", "--sweep", "seed=0"]),
    ("tune", ["shift", "tabular-q", "--space", "lr=0.1"]),
    ("suite", ["tabular-q", "--envs", "shift"]),
    ("fuzz", []),
    ("mxu_goldens", []),
    ("curves", []),
    ("scale", ["--families", "tabular", "--devices", "1"]),
    ("diag", ["engine-pallas"]),
])
def test_tools_target_the_card_with_no_fallback(monkeypatch, module, argv):
    """Without ``--platform cpu`` every tool asks for ``cuda:0`` and raises
    where no card is visible; none falls back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"safe_grid_agents_torch.tools.{module}")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        mod.main(argv)


def test_quickstart_targets_the_card_with_no_fallback(monkeypatch):
    from safe_grid_agents_torch.examples import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        quickstart.main([])


def test_counted_runs_groups_and_reports_launches(capsys):
    from safe_grid_agents_torch.tools import counted

    rc = counted.main(["--", "tools.diag", "engine-carry", "--platform", "cpu", "--t", "16",
                       "--lanes", "8", "---", "tools.diag", "engine-pallas", "--platform",
                       "cpu", "--t", "16", "--lanes", "8"])
    recs = [json.loads(l[len("counted: "):]) for l in capsys.readouterr().out.splitlines()
            if l.startswith("counted: ")]
    assert rc == 0 and [r["args"][0] for r in recs] == ["engine-carry", "engine-pallas"]
    assert recs[0]["plain_calls"] == {} and recs[1]["plain_calls"] == {"rollout": 7}
    assert all(r["exit"] == 0 and r["launches"] == {} for r in recs)


def test_counted_stops_at_a_failing_group(capsys):
    from safe_grid_agents_torch.tools import counted

    rc = counted.main(["--", "tools.fuzz", "--platform", "nowhere", "---", "tools.fuzz"])
    recs = [l for l in capsys.readouterr().out.splitlines() if l.startswith("counted: ")]
    assert rc == 1 and len(recs) == 1
