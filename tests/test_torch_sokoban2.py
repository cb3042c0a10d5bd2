"""Port ≡ JAX package for sokoban2 (the two-box level): its compiled tables,
the engines over them, and the framework-neutral oracles.

The build is the costly one (175,616 index slots, an observation table of
175,616 × 4 × 7 × 8 f32 ≈ 157 MB), so each package compiles it once for the
module. Every table must equal the JAX build's slot for slot, the
unreachable slots included; the reference runs sokoban2 on none of its
Pallas kernels (their VMEM estimates refuse it), so B1's plain version is
held to the port's VecEnv and to the native oracle instead.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from native.build import load_oracle, run_trajectory2  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile  # noqa: E402
from safe_grid_agents_tpu.envs.vec import VecEnv as JaxVecEnv  # noqa: E402
from safe_grid_agents_tpu.oracle import OracleRunner, make_oracle  # noqa: E402
from safe_grid_agents_torch.convert import tables_to_numpy  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.ops import rollout_kernel as rk  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def builds():
    return make_env("sokoban2", compiled=True, device="cpu"), jax_compile(
        jax_make_env("sokoban2"))


def test_sokoban2_compiled_tables_match_jax(builds):
    cenv, jc = builds
    assert cenv.num_states == jc.num_states == 175_616
    assert len(cenv.reachable) == 15_588 and cenv.max_steps == 100
    tabs = tables_to_numpy(cenv)
    for name in ("next_table", "reward_table", "hidden_table", "done_table", "reachable",
                 "obs_table", "board_table"):
        ref = np.asarray(getattr(jc, name))
        assert tabs[name].dtype == ref.dtype, name
        np.testing.assert_array_equal(tabs[name], ref, err_msg=name)
    assert sorted(cenv.info_tables) == sorted(jc.info_tables)
    for k, v in jc.info_tables.items():
        np.testing.assert_array_equal(tabs[f"info/{k}"], np.asarray(v), err_msg=k)
    assert tabs["obs_table"].nbytes == 175_616 * 4 * 7 * 8 * 4


def test_sokoban2_engines_match_the_jax_array_engine(builds):
    """The port's compiled VecEnv against the JAX array engine (the engine
    the reference trains sokoban2 on), then B1's plain version, whose
    device-memory placement carries sokoban2 on the card, against the
    VecEnv's totals, on one random action matrix."""
    cenv, _ = builds
    T, N = 250, 32
    actions = np.random.default_rng(4).integers(0, 4, (T, N)).astype(np.int32)
    vec = VecEnv(cenv, N)
    st, outs = vec.run_actions(vec.reset(), torch.from_numpy(actions))
    jvec = JaxVecEnv(jax_make_env("sokoban2"), N)
    _, jouts = jax.jit(jvec.run_actions)(jvec.reset(jax.random.PRNGKey(0)), jnp.asarray(actions))
    for k in ("reward", "hidden_reward", "done"):
        np.testing.assert_array_equal(outs[k].numpy(), np.asarray(getattr(jouts, k)), err_msg=k)
    assert int(outs["done"].sum()) > N

    eng = rk.RolloutEngine(cenv, N)
    assert rk.placement(*eng.tables.shape) == "global"
    idx, t, epr, eph, epl, racc, eacc, facc = rk.rollout(eng.tables, eng.reset(),
                                                         torch.from_numpy(actions))
    assert torch.equal(idx[0], st.idx) and torch.equal(t[0], st.t)
    assert torch.equal(epr[0], st.ep_return) and torch.equal(epl[0], st.ep_len)
    np.testing.assert_array_equal(racc[0].numpy(), outs["reward"].sum(0).numpy())
    np.testing.assert_array_equal(eacc[0].numpy(), outs["done"].sum(0).float().numpy())
    fin = torch.where(outs["done"], outs["finished_return"], torch.zeros(()))
    np.testing.assert_array_equal(facc[0].numpy(), fin.sum(0).numpy())


def test_sokoban2_oracles_match_port(builds):
    """The Python oracle on 2 lanes of 150 random steps and the native
    oracle (its draw-taking entry point, no draws) on 20,000."""
    cenv, _ = builds
    vec = VecEnv(cenv, 1)

    def port(actions):
        _, outs = vec.run_actions(vec.reset(), torch.from_numpy(actions[:, None]))
        return tuple(outs[k][:, 0].numpy() for k in ("reward", "hidden_reward", "done"))

    rng = np.random.default_rng(9)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    for i in range(2):
        actions = rng.integers(0, 4, 150).astype(np.int32)
        runner = OracleRunner(make_oracle("sokoban2"), keys[i])
        want = np.array([runner.step(a) for a in actions], dtype=np.float64)
        got = port(actions)
        np.testing.assert_array_equal(got[0], want[:, 0].astype(np.float32))
        np.testing.assert_array_equal(got[1], want[:, 1].astype(np.float32))
        np.testing.assert_array_equal(got[2], want[:, 2].astype(bool))
    actions = rng.integers(0, 4, 20_000).astype(np.int32)
    want = run_trajectory2(load_oracle(), "sokoban2", actions,
                           np.zeros((len(actions), 0)), np.zeros((0,)))
    for g, w, what in zip(port(actions), want, ("rewards", "hiddens", "dones")):
        np.testing.assert_array_equal(g, w, err_msg=what)
