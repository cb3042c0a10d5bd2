"""A learner run repeats from its seed: tabular Q's TD sums are exact.

``TabularQAgent.learn`` sums each batch's TD errors as 64-bit fixed-point
integers (``ops/tabular_kernel.py::td_sums``), so its update is the same in
any order of the lanes; on the card a float ``index_add_`` adds with
atomics in an order that changes from run to run, and on the CPU it adds in
lane order, so a permutation of the lanes stands in for a second card run
here. The cases are duplicate-heavy: 4096 lanes on three states of shift.

* one ``learn`` call, and one chunk of ``MXUTabularQTrainer.train_chunk``
  on handed-over explore draws, bitwise unchanged under permutations of
  the lanes (on float sums, Q changes);
* the duplicate-heavy batch against the JAX agent's ``learn`` and the MXU
  trainer's ``_learn_matmul`` to atol 1e-6, as
  ``tests/test_torch_tabular.py::test_agent_learn_matches_jax`` holds a
  light batch: the reference sums in float32 in its own association.
"""
import dataclasses

import numpy as np
import pytest
import torch

from safe_grid_agents_torch.agents.tabular import TabularQAgent, TabularQState
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.vec import VecEnv
from safe_grid_agents_torch.training import MXUTabularQTrainer

torch.set_num_threads(1)
N = 4096
Q_ATOL = 1e-6


def _heavy_batch(seed: int, n: int = N):
    """``(env, q, batch)``: a random Q and ``n`` lanes on three reachable
    states of shift (about 340 lanes a cell), with fractional rewards and
    some episodes ending."""
    env = make_env("shift", compiled=True, device="cpu")
    rng = np.random.default_rng(seed)
    reach = env.reachable.numpy()
    three = rng.choice(reach, 3, replace=False)
    q = rng.normal(0.0, 1.0, (env.num_states, env.n_actions)).astype(np.float32)
    batch = (rng.choice(three, n).astype(np.int32),
             rng.integers(0, env.n_actions, n).astype(np.int32),
             rng.normal(0.0, 10.0, n).astype(np.float32),
             rng.choice(reach, n).astype(np.int32),
             rng.random(n) < 0.2)
    return env, q, batch


def _learn(agent, q, batch, perm=None):
    xs = [torch.from_numpy(x if perm is None else x[perm]) for x in batch]
    st = TabularQState(q=torch.from_numpy(q), step=torch.tensor(7, dtype=torch.int64))
    return agent.learn(st, *xs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_learn_is_unchanged_by_a_permutation_of_its_lanes(seed):
    env, q, batch = _heavy_batch(seed)
    agent = TabularQAgent(env, lr=0.2)
    first = _learn(agent, q, batch)
    assert int(first.step) == 7 + N
    assert not torch.equal(first.q, torch.from_numpy(q))
    rng = np.random.default_rng(100 + seed)
    for _ in range(5):
        again = _learn(agent, q, batch, rng.permutation(N))
        assert torch.equal(again.q, first.q), int((again.q != first.q).sum())
        assert int(again.step) == int(first.step)


def test_mxu_trainer_chunk_is_unchanged_by_a_permutation_of_its_lanes():
    """One chunk of the MXU tabular scan on shift's compiled engine from a
    random Q, the lanes on three states at random episode steps (so that the
    lanes of one (s, a) differ in whether their episode times out, and their
    TD errors differ): the lanes and the explore draws handed over are
    permuted together; Q and the step bitwise, the lanes permuted, the
    episode statistics equal."""
    env = make_env("shift", compiled=True, device="cpu")
    agent = TabularQAgent(env, lr=0.2, epsilon_anneal_steps=2000, epsilon_final=0.05)
    tr = MXUTabularQTrainer(agent, VecEnv(env, N))
    T = 24
    rng = np.random.default_rng(5)
    q0 = torch.from_numpy(rng.normal(0.0, 1.0, (env.num_states, env.n_actions))
                          .astype(np.float32))
    three = rng.choice(env.reachable.numpy(), 3, replace=False)
    idx = torch.from_numpy(rng.choice(three, N).astype(np.int32))
    t = torch.from_numpy(rng.integers(0, env.max_steps, N).astype(np.int32))
    rand_a = torch.from_numpy(rng.integers(0, env.n_actions, (T, N)).astype(np.int32))
    u = torch.from_numpy(rng.random((T, N), dtype=np.float32))
    runs = []
    for perm in (torch.arange(N), torch.from_numpy(rng.permutation(N))):
        astate, vs = tr.init()
        astate = TabularQState(q=q0.clone(), step=astate.step)
        vs = dataclasses.replace(vs, idx=idx[perm].clone(), t=t[perm].clone())
        astate, vs, stats = tr.train_chunk(astate, vs, None, T,
                                           explore=(rand_a[:, perm], u[:, perm]))
        runs.append((perm, astate, vs, stats))
    (p0, a0, v0, s0), (p1, a1, v1, s1) = runs
    assert int(a0.step) == int(a1.step) == T * N
    assert torch.equal(a1.q, a0.q), int((a1.q != a0.q).sum())
    assert not torch.equal(a0.q, q0)
    assert torch.equal(v1.idx, v0.idx[p1])
    assert float(s0.episodes) == float(s1.episodes) > 0


def test_duplicate_heavy_learn_matches_jax():
    """The duplicate-heavy batch through the JAX agent's ``learn`` (a float32
    scatter) and the MXU trainer's ``_learn_matmul`` (one-hot matmuls):
    both within atol 1e-6 of the port's exact sums."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    pytest.importorskip("optax")
    import jax.numpy as jnp

    from safe_grid_agents_tpu.agents.tabular import TabularQAgent as JaxTabularQAgent
    from safe_grid_agents_tpu.envs import make_env as jax_make_env
    from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile
    from safe_grid_agents_tpu.training.tabular_mxu import _learn_matmul

    env, q, batch = _heavy_batch(3)
    agent = TabularQAgent(env, lr=0.2)
    jagent = JaxTabularQAgent(jax_compile(jax_make_env("shift")), lr=0.2)
    got = _learn(agent, q, batch)
    jstate = jagent.init(None).replace(q=jnp.asarray(q), step=jnp.int32(7))
    jbatch = [jnp.asarray(x) for x in batch]
    for name, want in (("learn", jagent.learn(jstate, *jbatch)),
                       ("_learn_matmul", _learn_matmul(jagent, jstate, *jbatch))):
        np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=0, atol=Q_ATOL,
                                   err_msg=name)
        assert int(want.step) == int(got.step) == 7 + N, name


# ---- tools/repeat_cases.py (chip_smoke.py phase 8d) ----------------------------------

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", [
    "shift tabular-q --lr 0.2", "shift tabular-q --compiled --mxu",
    "sokoban2 tabular-q (suite recipe)", "friend tabular-q (suite recipe)",
    "island ppo-mlp --preset (fused)", "sokoban deep-q (fused)", "island ppo-mlp --mxu-parity",
    "corners ppo-crmdp --mxu", "PPOTrainer cnn corners", "MXUPPOTrainer cnn corners"])
def test_repeat_cases_path_repeats_on_the_cpu(name):
    """Each repeated path of phase 8d but the shift ppo-cnn preset (a chunk of
    65,536 CNN steps, minutes on the CPU) runs twice here: every leaf and
    eval row equal, and the leaves and rows are there to compare."""
    from safe_grid_agents_torch.tools import repeat_cases as rc

    (r,) = rc.repeat([name], torch.device("cpu"))
    assert r["repeats"] and r["leaves"] > 0 and r["evals"] > 0, r


def test_repeat_cases_digests_tell_a_changed_leaf():
    from safe_grid_agents_torch.tools import repeat_cases as rc

    st = TabularQState(q=torch.zeros(3, 4), step=torch.tensor(5))
    d = rc.tree_digests(st)
    assert set(d) == {"q", "step"}
    moved = TabularQState(q=torch.zeros(3, 4), step=torch.tensor(5))
    moved.q[1, 2] = 1e-30
    assert rc.tree_digests(moved)["q"] != d["q"] and rc.tree_digests(moved)["step"] == d["step"]
    assert rc.digest(torch.zeros(2)) != rc.digest(torch.zeros(2, dtype=torch.float64))
    assert rc.row_digest({"r": float("nan")}) == rc.row_digest({"r": float("nan")})


def test_repeat_cases_cut_keeps_each_command_shape():
    from safe_grid_agents_torch.tools import repeat_cases as rc

    argv = rc.cut(["shift", "ppo-cnn", "--preset", "--compiled", "--mxu"], 3)
    assert argv[-2:] == ["--steps", str(3 * 32 * 512 * 4)]
    argv = rc.cut(["shift", "tabular-q", "--steps", "99", "--n-envs", "8"], 2)
    assert argv.count("--steps") == 1 and argv[-1] == str(2 * 8 * 64)


def test_repeat_cases_probe_on_the_cpu():
    """The probe from the repository root (it reads chip_smoke.py's commands)
    on two runs: their walls reported, no run failed, and the census names
    tabular Q's int64 TD sums and float32 counts by their calling lines."""
    import json
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "safe_grid_agents_torch.tools.repeat_cases", "--probe",
         "--platform", "cpu", "--only", "shift tabular-q --lr", "PPOTrainer corners"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])["probe"]
    assert sorted(out["runs"]) == ["PPOTrainer corners", "shift tabular-q --lr 0.2"]
    assert out["errors"] == {}
    ops = {k.split(":")[0]: runs for k, runs in out["ops"].items()}
    for key in ("index_add_ cpu int64 @ safe_grid_agents_torch/ops/tabular_kernel.py",
                "index_add_ cpu float32 @ safe_grid_agents_torch/agents/tabular.py"):
        assert list(ops[key]) == ["shift tabular-q --lr 0.2"], (key, out["ops"])
