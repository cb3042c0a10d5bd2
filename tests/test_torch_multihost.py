"""Two launcher-variable processes training one data-parallel run (twins
of ``tests/test_multihost.py``): each is started as ``torchrun`` would
start it (``MASTER_ADDR``/``MASTER_PORT`` on a free localhost port,
``WORLD_SIZE`` = 2, ``RANK``, ``LOCAL_RANK``), joins the gloo group through
``parallel.multihost`` and runs ``tools/multihost_worker.py``: one PPO chunk
whose gradient all-reduce crosses the process boundary. Both processes must
report the same loss, parameter checksum and summed statistics.

Processes and limits: 2 worker processes a test, each waited on for at most
120 s (the sweep 600 s) and both killed past it; each collective times out
after the worker's ``--timeout``. The sweep over all 19 aliases is marked
``slow``, as the reference's is.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

from safe_grid_agents_torch.envs import ALL_ENV_ALIASES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(extra, timeout):
    port, n = _free_port(), 2
    procs = []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "safe_grid_agents_torch.tools.multihost_worker",
             "--timeout", str(timeout), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_psum_training():
    outs = _run_workers([], 120)
    assert [o["process"] for o in outs] == [0, 1]
    assert all(o["n_processes"] == 2 for o in outs)
    # Lockstep learner: identical loss and params on both processes.
    assert outs[0]["loss"] == outs[1]["loss"]
    assert outs[0]["param_checksum"] == outs[1]["param_checksum"]
    assert outs[0]["env_steps"] == outs[1]["env_steps"] == 4 * 32  # T=4 × 32 lanes


@pytest.mark.slow
def test_two_process_all_env_sweep():
    """Every gridworld alias: one DP chunk each, identical per-alias loss,
    checksum and episode statistics on both processes."""
    outs = _run_workers(["--sweep"], 600)
    a0, a1 = outs[0]["aliases"], outs[1]["aliases"]
    assert set(a0) == set(a1) == set(ALL_ENV_ALIASES) and len(a0) == 19
    for alias in ALL_ENV_ALIASES:
        assert a0[alias] == a1[alias], (alias, a0[alias], a1[alias])
        assert a0[alias]["env_steps"] == 4 * 16  # T=4 × 16 lanes
