"""Checkpoint/resume under ``--n-devices > 1`` (``utils/checkpoint.py``'s
rank files, the CLI's resume) on 2 gloo ranks of the CPU.

One module-scoped spawn (``launch.spawn``, a join timeout of ``TIMEOUT``
s) runs ``tools/tp_cases.py::resume_jobs``: for tabular-q, deep-q with
PER, and ppo-mlp without and with ``--tp 2``, a straight run and a half run
resumed to the same length through the CLI at ``--n-devices 2``; each
rank's final file must equal the straight run's leaf by leaf, bitwise (the
reference's ``_resume_twin`` contract, ``tests/test_cli.py:159-220``, on
every rank), and the final evals must agree. A step with one rank file
missing or no marker is not taken; a checkpoint written at another
``--n-devices`` or ``--tp`` is refused.
"""
import json
import shutil

import pytest
import torch

from safe_grid_agents_torch.cli.main import run
from safe_grid_agents_torch.parallel import launch
from safe_grid_agents_torch.tools import tp_cases
from safe_grid_agents_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
TIMEOUT = 240  # seconds for the spawn of 2 ranks
W = 2
CPU = ["--platform", "cpu"]
TWINS = list(tp_cases.RESUME_TWINS)


@pytest.fixture(autouse=True)
def _bounded_spawns(monkeypatch):
    monkeypatch.setattr(launch, "JOIN_TIMEOUT", TIMEOUT)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dp_resume")
    ranks = launch.spawn(tp_cases.resume_jobs, W, (TWINS, str(workdir)), timeout=TIMEOUT)
    return workdir, ranks


def _dir(workdir, name, leg):
    return workdir / name.replace(" ", "_") / leg


@pytest.mark.parametrize("name", TWINS)
def test_resume_twin_is_bitwise_on_every_rank(twins, name):
    _, ranks = twins
    for rank, rec in enumerate(ranks):
        r = rec[name]
        assert r["rank"] == rank and r["same_keys"] and r["leaves"] > 0
        assert r["differ"] == [], (name, rank, r["differ"][:5])
        assert r["resumed_line"] and not r["half_resumed"]
        assert json.dumps(r["finals"]["straight"]) == json.dumps(r["finals"]["resumed"])
    # The summed evals are the same on both ranks.
    assert json.dumps(ranks[0][name]["finals"]) == json.dumps(ranks[1][name]["finals"])
    assert tp_cases.first_failure([{name: rec[name]} for rec in ranks]) is None


@pytest.mark.parametrize("name", TWINS)
def test_each_rank_writes_its_own_tree(twins, name):
    workdir, ranks = twins
    tp = 2 if name.endswith("tp") else 1
    _, _, _, n_chunks = tp_cases.RESUME_TWINS[name]
    d = _dir(workdir, name, "straight")
    assert ranks[0][name]["layout"] == {"world": W, "tp": tp}
    assert ckpt.step_layout(str(d), n_chunks) == {"world": W, "tp": tp}
    # max_to_keep = 3 committed steps, every other chunk.
    assert ckpt.committed_steps(str(d)) == [n_chunks - 4, n_chunks - 2, n_chunks]
    files = sorted(p.name for p in (d / str(n_chunks)).iterdir())
    assert files == ["rank-0.pt", "rank-1.pt", ckpt.MARKER]
    a, b = (ckpt.read(str(d), n_chunks, rank=r) for r in range(W))
    assert a.keys() == b.keys()
    if name.startswith("dqn"):
        # Each rank's ring holds the capacity over the data ranks, and its own
        # transitions.
        assert a["0/buffer/priorities"].shape == (1024 // W,)
        assert not torch.equal(a["0/buffer/storage/action"], b["0/buffer/storage/action"])
    if name == "ppo tp":
        # Each model rank keeps its own column of Dense_0.
        assert a["0/params/Dense_0.kernel"].shape[1] == 16
        assert not torch.equal(a["0/params/Dense_0.kernel"], b["0/params/Dense_0.kernel"])
        assert torch.equal(a["0/params/Dense_2.kernel"], b["0/params/Dense_2.kernel"])


@pytest.mark.parametrize("tear", ["rank file", "marker"])
def test_a_torn_step_is_not_taken(twins, tmp_path, tear):
    workdir, _ = twins
    _, _, _, n_chunks = tp_cases.RESUME_TWINS["tabular"]
    d = tmp_path / "ck"
    shutil.copytree(_dir(workdir, "tabular", "straight"), d)
    (d / str(n_chunks) / ("rank-1.pt" if tear == "rank file" else ckpt.MARKER)).unlink()
    assert ckpt.step_layout(str(d), n_chunks) is None
    assert ckpt.latest_step(str(d)) == n_chunks - 2


def test_resume_at_another_layout_is_refused(twins, tmp_path):
    workdir, _ = twins
    flags = tp_cases.RESUME_TWINS["ppo tp"][0]
    tp_dir = str(_dir(workdir, "ppo tp", "straight"))
    with pytest.raises(SystemExit, match="--n-devices 2 --tp 2, this run is --n-devices 2 "
                                         "--tp 1"):
        run([f for f in flags if f not in ("--tp", "2")] + [
            "--n-devices", "2", "--resume", "--checkpoint-dir", tp_dir] + CPU)
    ddp_dir = str(_dir(workdir, "tabular", "straight"))
    with pytest.raises(SystemExit, match="--n-devices 2 --tp 1, this run is --n-devices 1"):
        run(tp_cases.RESUME_TWINS["tabular"][0] + ["--resume", "--checkpoint-dir", ddp_dir]
            + CPU)
    # One process's checkpoint, resumed on 2 ranks.
    one = str(tmp_path / "one")
    run(["shift", "tabular-q", "--n-envs", "16", "--steps", "512", "--chunk-steps", "16",
         "--eval-steps", "4", "--checkpoint-dir", one] + CPU)
    with pytest.raises(SystemExit, match="--n-devices 1 --tp 1, this run is --n-devices 2"):
        run(["shift", "tabular-q", "--n-envs", "16", "--steps", "1024", "--chunk-steps",
             "16", "--n-devices", "2", "--resume", "--checkpoint-dir", one] + CPU)
