"""Rules of the port: no JAX on its side, no silent CPU fallback, and state
that crosses between the packages round-trips."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from safe_grid_agents_torch import convert
from safe_grid_agents_torch.agents.tabular import TabularQAgent
from safe_grid_agents_torch.cli.main import run
from safe_grid_agents_torch.device import resolve_device
from safe_grid_agents_torch.envs import make_env

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
# The JAX stack, the JAX package, and the repo-root reference tools and
# examples (``tools/``, ``examples/``), which drive the JAX package.
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "safe_grid_agents_tpu", "yaml", "tools",
          "examples"}


def _port_files():
    return sorted((ROOT / "safe_grid_agents_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in BANNED, f"{path}:{node.lineno} imports {m}"


def test_cpu_run_leaves_jax_unimported():
    code = (
        "import sys\n"
        "from safe_grid_agents_torch.cli.main import run\n"
        "s = run(['shift', 'tabular-q', '--compiled', '--mxu', '--fused-kernel',"
        " '--platform', 'cpu', '--n-envs', '8', '--chunk-steps', '16',"
        " '--steps', '128', '--eval-steps', '16'])\n"
        "assert s['env_steps'] == 128, s\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'optax', 'orbax', 'safe_grid_agents_tpu', 'yaml'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_card_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: resolve_device(),
        lambda: make_env("shift", compiled=True),
        lambda: TabularQAgent(make_env("shift", compiled=True, device="cpu")).init(),
        lambda: convert.engine_state_from_numpy([np.zeros(2)] * 5),
        lambda: run(["shift", "tabular-q", "--compiled", "--mxu", "--fused-kernel",
                     "--preset"]),
    ):
        with pytest.raises(RuntimeError, match="--platform cpu"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_convert_round_trips():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(63, 4)).astype(np.float32)
    q2, step = convert.tabular_state_to_numpy(
        convert.tabular_state_from_numpy(q, 2**31 + 5, "cpu"))
    np.testing.assert_array_equal(q2, q)
    assert step == 2**31 + 5  # the port's counter is int64
    state = (rng.integers(0, 63, (1, 16)).astype(np.int32),
             rng.integers(0, 100, 16).astype(np.int32),
             rng.normal(size=16).astype(np.float32),
             rng.normal(size=(1, 16)).astype(np.float32),
             rng.integers(0, 100, 16).astype(np.int32))
    back = convert.engine_state_to_numpy(convert.engine_state_from_numpy(state, "cpu"))
    for x, y in zip(back, state):
        assert x.shape == (1, 16) and x.dtype == y.dtype
        np.testing.assert_array_equal(x, np.reshape(y, (1, 16)))
    cenv = make_env("shift-test", compiled=True, device="cpu")
    tabs = convert.tables_to_numpy(cenv)
    again = {k: v.numpy() for k, v in convert.tables_from_numpy(tabs, "cpu").items()}
    assert sorted(again) == sorted(tabs)
    for k in tabs:
        assert again[k].dtype == tabs[k].dtype
        np.testing.assert_array_equal(again[k], tabs[k])
