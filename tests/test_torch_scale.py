"""Weak scaling and the counted all-reduce bytes
(``safe_grid_agents_torch/tools/scale.py``) on gloo ranks of the CPU.

* tabular and dqn at 1 and 2 devices: per-device env work constant, the
  global env steps exact multiples, the all-reduce calls a chunk the
  port's (``EXPECTED_CALLS``) and the counted bytes the analytic model;
* the counted bytes equal the reference's analytic bytes for the same
  shapes (tabular Q's int64 table twice them, ``scale.port_payload``),
  from ``tools/scale.py --json`` run as a subprocess (importing it here
  would re-set ``jax_platforms`` after conftest initialised JAX);
* the counter reads the same calls at world size 1: the trainers do not
  skip their collectives in a group of one rank.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from safe_grid_agents_torch.parallel.collectives import all_reduce_counts, psum_flat
from safe_grid_agents_torch.parallel.launch import single_rank
from safe_grid_agents_torch.parallel.mesh import make_mesh
from safe_grid_agents_torch.tools import scale

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def rows():
    return scale.main(["--families", "tabular,dqn", "--devices", "1,2", "--json", "-q",
                       "--platform", "cpu"])


@pytest.fixture(scope="module")
def reference_rows():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "tools/scale.py", "--json", "--families",
                          "tabular,dqn", "--devices", "1,2", "-q"], capture_output=True,
                         text=True, cwd=ROOT, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]


def test_weak_scaling_rows(rows):
    assert [(r["family"], r["devices"]) for r in rows] == [
        ("tabular", 1), ("tabular", 2), ("dqn", 1), ("dqn", 2)]
    for r in rows:
        assert r["env_steps_per_device"] == scale.CHUNK * scale.ENVS_PER_DEV
        assert r["env_steps_per_chunk"] == scale.CHUNK * scale.ENVS_PER_DEV * r["devices"]
        assert r["allreduce_calls"] == scale.EXPECTED_CALLS[r["family"]]
        assert r["backend"] == "gloo"


def test_counted_bytes_equal_reference_analytic(rows, reference_rows):
    ref = {(r["family"], r["devices"]): r for r in reference_rows}
    for r in rows:
        want = ref[(r["family"], r["devices"])]
        for k in ("env_steps_per_chunk", "env_steps_per_device", "allreduce_bytes_per_chunk",
                  "allreduce_bytes_per_env_step", "note"):
            assert r[k] == want[k], (r["family"], r["devices"], k, r[k], want[k])
        # The counted payload, one rank's: the reference's analytic bytes
        # (which it reports at W > 1) at every W, tabular Q's table in int64
        # (its exact fixed-point sums: twice the reference's float32 bytes).
        analytic = ref[(r["family"], 2)]["allreduce_bytes_per_chunk"]
        want = scale.port_payload(r["family"], analytic)
        assert r["allreduce_counted_bytes"] == want, (r, analytic, want)


def test_counter_reads_the_same_calls_at_world_size_1(rows):
    by = {(r["family"], r["devices"]): r for r in rows}
    for fam in ("tabular", "dqn"):
        one, two = by[(fam, 1)], by[(fam, 2)]
        assert one["allreduce_calls"] == two["allreduce_calls"] > 0
        assert one["allreduce_counted_bytes"] == two["allreduce_counted_bytes"] > 0
        assert one["allreduce_bytes_per_chunk"] == 0  # the reference's W = 1 column


def test_counter_counts_calls_and_bytes():
    with single_rank("gloo"):
        group = make_mesh()
        all_reduce_counts.reset()
        psum_flat([torch.ones(3), torch.zeros(5)], group)
        psum_flat([torch.ones(2, dtype=torch.int64)], group)
        assert (all_reduce_counts.calls, all_reduce_counts.bytes) == (2, 8 * 4 + 2 * 8)
        all_reduce_counts.reset()
        assert (all_reduce_counts.calls, all_reduce_counts.bytes) == (0, 0)
