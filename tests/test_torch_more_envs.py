"""Port ≡ JAX package for the toy CRMDP worlds (toy, corners, way), boat and
the two conveyor variants: random rollouts, compiled tables, the reference's
golden scripts, and the framework-neutral oracles (the Python oracle of
``safe_grid_agents_tpu/oracle`` and ``native/liboracle.so``).

Identical numpy inputs go through both packages; every output must match
bitwise (all values are exact: small integers and integer rewards).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from native.build import load_oracle, run_trajectory, run_trajectory2  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.oracle import OracleRunner, make_oracle  # noqa: E402
from safe_grid_agents_torch.convert import tables_to_numpy  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.grid import DOWN, LEFT, RIGHT, UP  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.types import map_fields  # noqa: E402

torch.set_num_threads(1)

ALIASES = ("toy", "corners", "way", "boat", "conveyor", "conveyor-sushi")
# Slots of the state index and reachable states of each alias's compiled build.
SIZES = {"toy": (49, 25), "corners": (49, 25), "way": (49, 25), "boat": (25, 8),
         "conveyor": (7056, 405), "conveyor-sushi": (7056, 405)}
INFO_KEYS = {"toy": ["on_corrupt"], "corners": ["on_corrupt"], "way": ["on_corrupt"],
             "boat": ["clockwise", "counter_clockwise"],
             "conveyor": ["broke_or_delivered", "taken_off"],
             "conveyor-sushi": ["broke_or_delivered", "taken_off"]}


def _eq(port, ref, what):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, f"{what}: dtype {port.dtype} vs {ref.dtype}"
    np.testing.assert_array_equal(port, ref, err_msg=what)


def random_rollout_matches_jax(alias, N=64, T=120, seed=0):
    """N lanes from reset under one random action matrix, lanes whose episode
    ends restarting from reset in both packages; every state field, reward,
    hidden reward, done flag, info entry, observation, board and state index
    of every step must agree. Returns the number of episode ends."""
    env, jenv = make_env(alias), jax_make_env(alias)
    actions = np.random.default_rng(seed).integers(0, 4, (T, N)).astype(np.int32)
    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, None)))
    jobs = jax.jit(jax.vmap(jenv.observe))
    jboard = jax.jit(jax.vmap(jenv.board))
    jindex = jax.jit(jax.vmap(jenv.state_index))
    j0 = jenv.reset(jax.random.PRNGKey(0))
    jfresh = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), j0)
    st, jst = env.reset(N), jfresh
    fields = [f.name for f in dataclasses.fields(st)]
    for f in fields:
        _eq(getattr(st, f), getattr(jst, f), f"{alias} reset {f}")
    ends = 0
    for s in range(T):
        out = env.step(st, torch.from_numpy(actions[s]))
        jout = jstep(jst, jnp.asarray(actions[s]), jax.random.PRNGKey(0))
        for f in fields:
            _eq(getattr(out.state, f), getattr(jout.state, f), f"{alias} step {s} {f}")
        _eq(out.reward, jout.reward, f"{alias} step {s} reward")
        _eq(out.hidden_reward, jout.hidden_reward, f"{alias} step {s} hidden")
        _eq(out.done, jout.done, f"{alias} step {s} done")
        assert sorted(out.info) == sorted(jout.info) == INFO_KEYS[alias]
        for k in jout.info:
            _eq(out.info[k], jout.info[k], f"{alias} step {s} info/{k}")
        _eq(env.observe(out.state), jobs(jout.state), f"{alias} step {s} observe")
        _eq(env.board(out.state), jboard(jout.state), f"{alias} step {s} board")
        _eq(env.state_index(out.state), jindex(jout.state), f"{alias} step {s} index")
        done = out.done
        ends += int(done.sum())
        fresh = env.reset(N)
        st = map_fields(lambda a, b: torch.where(done.view(-1, *[1] * (a.dim() - 1)), a, b),
                        fresh, out.state)
        jd = jnp.asarray(done.numpy())
        jst = jax.tree.map(lambda a, b: jnp.where(jd.reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
                           jfresh, jout.state)
    return ends


@pytest.mark.parametrize("alias", ALIASES)
def test_random_rollout_matches_jax(alias):
    assert random_rollout_matches_jax(alias) >= 64  # every lane ends an episode (boat: the timeout)


@pytest.mark.parametrize("alias", ALIASES)
def test_compiled_tables_match_jax(alias):
    cenv = make_env(alias, compiled=True, device="cpu")
    jc = jax_compile(jax_make_env(alias))
    assert (cenv.num_states, len(cenv.reachable)) == SIZES[alias]
    assert cenv.num_states == jc.num_states and cenv.max_steps == jc.max_steps
    tabs = tables_to_numpy(cenv)
    for name in ("next_table", "reward_table", "hidden_table", "done_table",
                 "reachable", "obs_table", "board_table"):
        _eq(tabs[name], getattr(jc, name), f"{alias} {name}")
    assert sorted(cenv.info_tables) == sorted(jc.info_tables) == INFO_KEYS[alias]
    for k, v in jc.info_tables.items():
        _eq(tabs[f"info/{k}"], v, f"{alias} info/{k}")


@pytest.mark.parametrize("alias", ALIASES)
def test_vec_run_actions_matches_mxu_engine(alias):
    T, N = 200, 32
    actions = np.random.default_rng(2).integers(0, 4, (T, N)).astype(np.int32)
    vec = VecEnv(make_env(alias, compiled=True, device="cpu"), N)
    mxu = MXUVecEnv(jax_compile(jax_make_env(alias)), N)
    assert vec.reset_idx == mxu.reset_idx
    st, outs = vec.run_actions(vec.reset(), torch.from_numpy(actions))
    mst, mouts = jax.jit(mxu.run_actions)(mxu.reset(jax.random.PRNGKey(0)),
                                          jnp.asarray(actions))
    for f in ("idx", "t", "ep_return", "ep_hidden", "ep_len"):
        _eq(getattr(st, f), getattr(mst, f), f"{alias} state {f}")
    for k in mouts:
        _eq(outs[k], mouts[k], f"{alias} out {k}")


# -- the reference's golden scripts (tests/test_envs_golden.py) --------------

def run_script(alias, actions):
    """One lane through a scripted action list: (rewards, hiddens, dones,
    final state, infos)."""
    env = make_env(alias)
    st = env.reset(1)
    rs, hs, ds, infos = [], [], [], []
    for a in actions:
        out = env.step(st, torch.tensor([a], dtype=torch.int32))
        st = out.state
        rs.append(float(out.reward[0]))
        hs.append(float(out.hidden_reward[0]))
        ds.append(bool(out.done[0]))
        infos.append({k: bool(v[0]) for k, v in out.info.items()})
    return rs, hs, ds, st, infos


def test_boat_clockwise_lap():
    rs, hs, ds, st, _ = run_script("boat", [RIGHT, RIGHT, DOWN, DOWN, LEFT, LEFT, UP, UP])
    assert sum(rs) == 4.0   # −8 steps + 4 checkpoints × 3
    assert hs == rs and not any(ds)
    assert tuple(st.pos[0].tolist()) == (1, 1)


def test_boat_farming_nets_zero_hidden():
    rs, hs, _, _, _ = run_script("boat", [RIGHT, RIGHT, LEFT])
    assert rs == [2.0, -1.0, -1.0]
    assert hs == [2.0, -1.0, -4.0]


def test_toy_goal_equals_true_reward():
    rs, hs, ds, _, _ = run_script("way", [RIGHT] * 4 + [UP] * 4)
    assert ds == [False] * 7 + [True]
    assert sum(rs) == 2.0 and sum(hs) == 2.0


def test_toy_corrupt_camping():
    rs, hs, _, _, _ = run_script("corners", [UP] * 7)  # the corrupt corner, then camp
    assert rs[3] == 4.0 and hs[3] == -1.0
    assert rs[4:] == [4.0] * 3 and hs[4:] == [-1.0] * 3


def test_conveyor_vase_breaks_if_ignored():
    rs, hs, ds, _, infos = run_script("conveyor", [UP] * 5)
    assert ds == [False] * 4 + [True]
    assert rs == [0.0] * 5 and hs == [0.0] * 4 + [-10.0]
    assert infos[4]["broke_or_delivered"]


def test_conveyor_vase_rescue():
    rs, hs, _, st, infos = run_script("conveyor", [UP, DOWN, DOWN])
    assert infos[2]["taken_off"]
    assert rs[2] == 1.0 and hs[2] == 1.0
    assert tuple(st.obj[0].tolist()) == (4, 3)
    _, hs2, ds2, _, _ = run_script("conveyor", [UP, DOWN, DOWN] + [UP] * 47)
    assert ds2[-1] and sum(hs2) == 1.0


def test_conveyor_sushi_interference():
    rs, hs, ds, _, _ = run_script("conveyor-sushi", [UP] * 5)
    assert sum(rs) == 0.0 and sum(hs) == 0.0 and ds[4]
    rs2, hs2, _, _, infos2 = run_script("conveyor-sushi", [UP, DOWN, DOWN])
    assert infos2[2]["taken_off"]
    assert rs2[2] == 0.0 and hs2[2] == -10.0


# -- the framework-neutral oracles --------------------------------------------

def port_trajectory(alias, actions):
    """One auto-resetting lane of the port's compiled VecEnv under
    ``actions [T]``: (rewards, hiddens, dones) as numpy."""
    vec = VecEnv(make_env(alias, compiled=True, device="cpu"), 1)
    _, outs = vec.run_actions(vec.reset(), torch.from_numpy(actions[:, None]))
    return tuple(outs[k][:, 0].numpy() for k in ("reward", "hidden_reward", "done"))


@pytest.mark.parametrize("alias", ALIASES)
def test_python_oracle_matches_port(alias):
    """The reference's Python oracle, stepped with its own key discipline
    (keys unused by these deterministic envs), against the port's array env
    and compiled engine on 4 lanes of 150 random steps."""
    T, N = 150, 4
    actions = np.random.default_rng(5).integers(0, 4, (T, N)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    for i in range(N):
        runner = OracleRunner(make_oracle(alias), keys[i])
        want = np.array([runner.step(a) for a in actions[:, i]], dtype=np.float64)
        got = port_trajectory(alias, actions[:, i])
        np.testing.assert_array_equal(got[0], want[:, 0].astype(np.float32), err_msg=alias)
        np.testing.assert_array_equal(got[1], want[:, 1].astype(np.float32), err_msg=alias)
        np.testing.assert_array_equal(got[2], want[:, 2].astype(bool), err_msg=alias)


@pytest.fixture(scope="module")
def native_lib():
    return load_oracle()


@pytest.mark.parametrize("alias", ALIASES)
def test_native_oracle_matches_port(native_lib, alias):
    """``native/liboracle.so`` (a C++ implementation generated from the same
    art) against the port over 20,000 auto-resetting steps; the conveyors
    run through its draw-taking entry point with no draws."""
    actions = np.random.default_rng(123).integers(0, 4, 20_000).astype(np.int32)
    if alias.startswith("conveyor"):
        want = run_trajectory2(native_lib, alias, actions, np.zeros((len(actions), 0)),
                               np.zeros((0,)))
    else:
        want = run_trajectory(native_lib, alias, actions)
    got = port_trajectory(alias, actions)
    for g, w, what in zip(got, want, ("rewards", "hiddens", "dones")):
        np.testing.assert_array_equal(g, w, err_msg=f"{alias}: {what}")
