"""Port ≡ JAX package for sokoban: the env (both levels), its compiled tables
and the VecEnv over them.

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
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.envs.sokoban import Sokoban as JaxSokoban  # noqa: E402
from safe_grid_agents_tpu.envs.sokoban import State as JaxState  # noqa: E402
from safe_grid_agents_torch.convert import tables_to_numpy  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.compiled import TableState  # noqa: E402
from safe_grid_agents_torch.envs.sokoban import Sokoban, State  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402

torch.set_num_threads(1)


def _eq(port, ref, what):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, f"{what}: dtype {port.dtype} vs {ref.dtype}"
    np.testing.assert_array_equal(port, ref, err_msg=what)


@pytest.mark.parametrize("level", [0, 1])
def test_sokoban_random_rollout_matches_jax(level):
    """64 lanes from reset under one random action matrix; lanes whose
    episode ends restart from reset. Every field of every step must agree,
    and boxes must actually get pushed."""
    N, T = 64, 150  # T > max_steps: crosses the timeout
    env, jenv = Sokoban(level), JaxSokoban(level)
    actions = np.random.default_rng(level).integers(0, 4, (T, N)).astype(np.int32)
    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, None)))
    jobs = jax.jit(jax.vmap(jenv.observe))
    jboard = jax.jit(jax.vmap(jenv.board))
    jindex = jax.jit(jax.vmap(jenv.state_index))
    st = env.reset(N)
    j0 = jenv.reset(jax.random.PRNGKey(0))
    jst = JaxState(pos=jnp.broadcast_to(j0.pos, (N, 2)),
                   boxes=jnp.broadcast_to(j0.boxes, (N,) + j0.boxes.shape),
                   t=jnp.zeros((N,), jnp.int32))
    _eq(st.pos, jst.pos, "reset pos")
    _eq(st.boxes, jst.boxes, "reset boxes")
    pushes = 0
    for s in range(T):
        out = env.step(st, torch.from_numpy(actions[s]))
        jout = jstep(jst, jnp.asarray(actions[s]), jax.random.PRNGKey(0))
        for f in ("pos", "boxes", "t"):
            _eq(getattr(out.state, f), getattr(jout.state, f), f"step {s} {f}")
        _eq(out.reward, jout.reward, f"step {s} reward")
        _eq(out.hidden_reward, jout.hidden_reward, f"step {s} hidden")
        _eq(out.done, jout.done, f"step {s} done")
        assert sorted(out.info) == sorted(jout.info)
        for k in jout.info:
            _eq(out.info[k], jout.info[k], f"step {s} info/{k}")
        _eq(env.observe(out.state), jobs(jout.state), f"step {s} observe")
        _eq(env.board(out.state), jboard(jout.state), f"step {s} board")
        _eq(env.state_index(out.state), jindex(jout.state), f"step {s} index")
        pushes += int(out.info["pushed"].sum())
        done = out.done
        fresh = env.reset(N)
        st = State(pos=torch.where(done[:, None], fresh.pos, out.state.pos),
                   boxes=torch.where(done[:, None, None], fresh.boxes, out.state.boxes),
                   t=torch.where(done, fresh.t, out.state.t))
        jd = jnp.asarray(done.numpy())
        jst = JaxState(pos=jnp.where(jd[:, None], j0.pos, jout.state.pos),
                       boxes=jnp.where(jd[:, None, None], j0.boxes, jout.state.boxes),
                       t=jnp.where(jd, 0, jout.state.t))
    assert pushes > 0


def test_sokoban_compiled_tables_match_jax():
    cenv = make_env("sokoban", compiled=True, device="cpu")
    jc = jax_compile(jax_make_env("sokoban"))
    assert cenv.num_states == jc.num_states == 1296
    tabs = tables_to_numpy(cenv)
    for name in ("next_table", "reward_table", "hidden_table", "done_table",
                 "reachable", "obs_table", "board_table"):
        _eq(tabs[name], getattr(jc, name), name)
    assert sorted(cenv.info_tables) == sorted(jc.info_tables) == ["box_penalty", "pushed"]
    for k, v in jc.info_tables.items():
        _eq(tabs[f"info/{k}"], v, f"info/{k}")

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
    for f in ("reward", "hidden_reward", "done"):
        _eq(getattr(out, f), getattr(jout, f), f"step {f}")
    _eq(out.state.idx, jout.state.idx, "step idx")
    for k in jout.info:
        _eq(out.info[k], jout.info[k], f"step info/{k}")


def test_sokoban_vec_run_actions_matches_mxu_engine():
    T, N = 300, 64
    actions = np.random.default_rng(2).integers(0, 4, (T, N)).astype(np.int32)
    vec = VecEnv(make_env("sokoban", compiled=True, device="cpu"), N)
    mxu = MXUVecEnv(jax_compile(jax_make_env("sokoban")), N)
    assert vec.reset_idx == mxu.reset_idx
    st, outs = vec.run_actions(vec.reset(), torch.from_numpy(actions))
    mst, mouts = jax.jit(mxu.run_actions)(mxu.reset(jax.random.PRNGKey(0)),
                                          jnp.asarray(actions))
    for f in ("idx", "t", "ep_return", "ep_hidden", "ep_len"):
        _eq(getattr(st, f), getattr(mst, f), f"state {f}")
    for k in mouts:
        _eq(outs[k], mouts[k], f"out {k}")
    assert int(outs["done"].sum()) > N


def test_sokoban2_stays_unported():
    """sokoban2 is in the registry now (its tables are held to the JAX
    build's in ``test_torch_sokoban2.py``): both constructors give level 1,
    whose index space, (7·8)³ = 175,616 slots, puts its tables past one
    block's shared memory, so B1 keeps them in device memory."""
    from safe_grid_agents_torch.ops import rollout_kernel as rk

    assert Sokoban(1).num_states == 175_616
    env = make_env("sokoban2")
    assert isinstance(env, Sokoban) and env.n_boxes == 2
    assert (env.name, env.num_states, env.height, env.width) == (
        jax_make_env("sokoban2").name, 175_616, 7, 8)
    assert rk.placement(env.num_states, env.n_actions) == "global"
