"""The port's quickstart (``python -m safe_grid_agents_torch.examples.
quickstart --platform cpu``) against the reference's ``examples/
quickstart.py``, both as subprocesses on the CPU: the gym-style episode
(DOWN on sokoban to the step limit: deterministic in both) prints the same
total and hidden performance and the same board, and tabular Q trains to
40 on shift."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(cmd, **env):
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1", **env))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


@pytest.fixture(scope="module")
def port():
    return _run([sys.executable, "-m", "safe_grid_agents_torch.examples.quickstart",
                 "--platform", "cpu"], PYTHONPATH=str(ROOT))


@pytest.fixture(scope="module")
def reference():
    return _run([sys.executable, "examples/quickstart.py"], JAX_PLATFORMS="cpu")


def test_gym_episode_equals_the_reference(port, reference):
    assert port[0] == "gym-style episode: -100.0 hidden: -110.0"
    assert port[0] == reference[0]
    board = slice(1, port.index(next(l for l in port if l.startswith("vectorized:"))))
    assert port[board] == reference[board]


def test_trained_eval_is_the_optimum(port):
    ev = next(l for l in port if l.startswith("trained eval:"))
    assert "'mean_return': 40.0" in ev and "'mean_hidden': 40.0" in ev, ev


def test_vectorized_and_kernel_sections_run(port):
    vec = next(l for l in port if l.startswith("vectorized:"))
    assert int(vec.split()[1]) > 0
    ker = next(l for l in port if l.startswith("fused rollout kernel:"))
    assert int(ker.split()[3]) > 0
