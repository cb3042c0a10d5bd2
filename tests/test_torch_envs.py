"""Port ≡ JAX package for the shift envs, their compiled tables and VecEnv.

Identical numpy inputs go through both packages; every output must match
bitwise (all values are exact: small integers and integer rewards).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import TableState as JaxTableState  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile  # noqa: E402
from safe_grid_agents_tpu.envs.distributional_shift import State as JaxState  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_torch.convert import tables_to_numpy  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.compiled import TableState  # noqa: E402
from safe_grid_agents_torch.envs.distributional_shift import State  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402

torch.set_num_threads(1)
ALIASES = ["shift", "shift-test"]


def _eq(port, ref, what):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, f"{what}: dtype {port.dtype} vs {ref.dtype}"
    np.testing.assert_array_equal(port, ref, err_msg=what)


@pytest.mark.parametrize("alias", ALIASES)
def test_env_step_observe_board_index_match_jax(alias):
    rng = np.random.default_rng(0)
    n = 512
    env, jenv = make_env(alias), jax_make_env(alias)
    pos = np.stack([rng.integers(1, env.height - 1, n),
                    rng.integers(1, env.width - 1, n)], 1).astype(np.int32)
    t = rng.integers(0, env.max_steps, n).astype(np.int32)
    act = rng.integers(0, env.n_actions, n).astype(np.int32)

    out = env.step(State(pos=torch.from_numpy(pos), t=torch.from_numpy(t)),
                   torch.from_numpy(act))
    jst = JaxState(pos=jnp.asarray(pos), t=jnp.asarray(t))
    jout = jax.vmap(jenv.step, in_axes=(0, 0, None))(
        jst, jnp.asarray(act), jax.random.PRNGKey(0)
    )
    _eq(out.state.pos, jout.state.pos, "pos")
    _eq(out.state.t, jout.state.t, "t")
    _eq(out.reward, jout.reward, "reward")
    _eq(out.hidden_reward, jout.hidden_reward, "hidden")
    _eq(out.done, jout.done, "done")
    for k in jout.info:
        _eq(out.info[k], jout.info[k], f"info/{k}")
    st = State(pos=torch.from_numpy(pos), t=torch.from_numpy(t))
    _eq(env.observe(st), jax.vmap(jenv.observe)(jst), "observe")
    _eq(env.board(st), jax.vmap(jenv.board)(jst), "board")
    _eq(env.state_index(st), jax.vmap(jenv.state_index)(jst), "state_index")
    r0 = env.reset(3)
    jr0 = jenv.reset(jax.random.PRNGKey(0))
    _eq(r0.pos, np.broadcast_to(np.asarray(jr0.pos), (3, 2)), "reset pos")


@pytest.mark.parametrize("alias", ALIASES)
def test_compiled_tables_match_jax(alias):
    cenv = make_env(alias, compiled=True, device="cpu")
    jc = jax_compile(jax_make_env(alias))
    tabs = tables_to_numpy(cenv)
    for name in ("next_table", "reward_table", "hidden_table", "done_table",
                 "reachable", "obs_table", "board_table"):
        _eq(tabs[name], getattr(jc, name), name)
    assert sorted(cenv.info_tables) == sorted(jc.info_tables)
    for k, v in jc.info_tables.items():
        _eq(tabs[f"info/{k}"], v, f"info/{k}")

    # The compiled runtime step agrees too, on random reachable states.
    rng = np.random.default_rng(1)
    idx = rng.choice(tabs["reachable"], 256).astype(np.int32)
    t = rng.integers(0, cenv.max_steps, 256).astype(np.int32)
    act = rng.integers(0, cenv.n_actions, 256).astype(np.int32)
    out = cenv.step(TableState(torch.from_numpy(idx), torch.from_numpy(t)),
                    torch.from_numpy(act))
    jout = jax.vmap(jc.step, in_axes=(0, 0, None))(
        JaxTableState(jnp.asarray(idx), jnp.asarray(t)), jnp.asarray(act),
        jax.random.PRNGKey(0),
    )
    _eq(out.state.idx, jout.state.idx, "step idx")
    _eq(out.done, jout.done, "step done")
    _eq(out.reward, jout.reward, "step reward")


@pytest.mark.parametrize("alias", ALIASES)
def test_vec_run_actions_matches_mxu_engine(alias):
    T, N = 300, 64  # T > max_steps: crosses timeouts
    actions = np.random.default_rng(2).integers(0, 4, (T, N)).astype(np.int32)
    vec = VecEnv(make_env(alias, compiled=True, device="cpu"), N)
    mxu = MXUVecEnv(jax_compile(jax_make_env(alias)), N)
    assert vec.reset_idx == mxu.reset_idx

    st, outs = vec.run_actions(vec.reset(), torch.from_numpy(actions))
    mst, mouts = jax.jit(mxu.run_actions)(mxu.reset(jax.random.PRNGKey(0)),
                                          jnp.asarray(actions))
    for f in ("idx", "t", "ep_return", "ep_hidden", "ep_len"):
        _eq(getattr(st, f), getattr(mst, f), f"state {f}")
    assert sorted(outs) == sorted(mouts)
    for k in mouts:
        _eq(outs[k], mouts[k], f"out {k}")
    assert int(outs["done"].sum()) > N  # episodes did end and reset


def test_unported_alias_names_roadmap_item():
    """No alias is unported any more: the port's registry holds exactly the
    JAX registry's 19 aliases, each builds and names the same env, and an
    unknown alias raises ``KeyError`` listing them. (sokoban2 compiles in
    ``test_torch_sokoban2.py``, once for its module.)"""
    from safe_grid_agents_tpu.envs import ENV_REGISTRY as JAX_REGISTRY
    from safe_grid_agents_torch.envs import ALL_ENV_ALIASES, ENV_REGISTRY

    assert sorted(ENV_REGISTRY) == sorted(JAX_REGISTRY) == ALL_ENV_ALIASES
    assert len(ALL_ENV_ALIASES) == 19
    for alias in ALL_ENV_ALIASES:
        env, jenv = make_env(alias), jax_make_env(alias)
        assert (env.name, env.num_states, env.max_steps, env.n_planes) == (
            jenv.name, jenv.num_states, jenv.max_steps, jenv.n_planes), alias
        if alias not in ("sokoban2", "friend", "foe", "neutral"):  # the friend family
            # compiles through its bounded substitute (test_torch_stoch_envs.py)
            assert make_env(alias, compiled=True, device="cpu").num_states == env.num_states
    with pytest.raises(KeyError, match="known"):
        make_env("sokoban3")
