"""Port ≡ JAX package for the eight stochastic aliases, their compiled tables
and the reset/mechanics analysis of the stochastic engines.

The port's envs take their draws as tensors; the JAX envs draw from
threefry keys. Each test draws from the keys with the JAX env's own
protocol (the reset coin ``bernoulli(key, 0.5)``; whisky's ``split`` into
the stumble coin and the random action; tomato's ``[K]`` dry vector) and
hands the same numbers to the port's draw-taking forms. Every value is
exact (small integers, integer or half-integer rewards), so every output
must be equal.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import TableState as JaxTableState  # noqa: E402
from safe_grid_agents_tpu.envs.friend_foe import BoundedFriendFoe as JaxBounded  # noqa: E402
from safe_grid_agents_tpu.envs.friend_foe import FriendFoe as JaxFriendFoe  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.ops.stoch_rollout_kernel import PallasStochRolloutEngine  # noqa: E402
from safe_grid_agents_torch.convert import tables_to_numpy  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.compiled import TableState  # noqa: E402
from safe_grid_agents_torch.envs.friend_foe import BoundedFriendFoe  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.types import map_fields  # noqa: E402

torch.set_num_threads(1)
ALIASES = ["absent", "interrupt", "whisky", "tomato", "tomato-crmdp",
           "friend", "foe", "neutral"]
FRIENDS = ("friend", "foe", "neutral")
CAP = 15


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(port, ref, what):
    port, ref = _np(port), np.asarray(ref)
    assert port.dtype == ref.dtype, f"{what}: dtype {port.dtype} vs {ref.dtype}"
    np.testing.assert_array_equal(port, ref, err_msg=what)


def _eq_state(port, ref, what):
    for f in ref.__dataclass_fields__:
        _eq(getattr(port, f), getattr(ref, f), f"{what} {f}")


def _coins(keys):
    return torch.from_numpy(np.asarray(
        jax.vmap(lambda k: jax.random.bernoulli(k, 0.5))(keys)).astype(np.int32))


def _step_draws(env, keys):
    """The port's draws for one step, from the keys the JAX step consumes."""
    if hasattr(env, "noisy_action"):
        ks = jax.vmap(jax.random.split)(keys)
        stumble = jax.vmap(lambda k: jax.random.bernoulli(k, 0.9))(ks[:, 0])
        rand = jax.vmap(lambda k: jax.random.randint(k, (), 0, 4))(ks[:, 1])
        return {"stumble": torch.from_numpy(np.array(stumble)),
                "rand_action": torch.from_numpy(np.array(rand))}
    if hasattr(env, "stochastic_index"):
        dry = jax.vmap(lambda k: jax.random.bernoulli(k, 0.05, (env.n_tomatoes,)))(keys)
        return {"dry": torch.from_numpy(np.array(dry))}
    return None


def _port_reset(env, state, keys, n):
    coin = _coins(keys)
    if state is not None and hasattr(env, "carry_reset_from_coin"):
        return env.carry_reset_from_coin(state, coin)
    if hasattr(env, "reset_from_coin"):
        return env.reset_from_coin(coin)
    return env.reset(n)


def _jax_reset(jenv, jstate, keys):
    if isinstance(jenv, JaxFriendFoe):  # carried across episodes
        return jax.vmap(jenv.carry_reset)(jstate, keys)
    return jax.vmap(jenv.reset)(keys)


def _envs(alias):
    if alias == "friend-bounded":
        return BoundedFriendFoe("friend", cap=3), JaxBounded("friend", cap=3)
    return make_env(alias), jax_make_env(alias)


@pytest.mark.parametrize("alias", ALIASES + ["friend-bounded"])
def test_env_rollout_matches_jax_on_the_same_draws(alias):
    """Random rollouts with auto-reset (carried for the friend family),
    long enough to cross timeouts and, at cap 3, the bounded memory's clamp."""
    env, jenv = _envs(alias)
    N, T = 48, 110
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def jax_step(jstate, act, step_keys, reset_keys):
        jout = jax.vmap(jenv.step)(jstate, act, step_keys)
        views = (jax.vmap(jenv.observe)(jout.state), jax.vmap(jenv.board)(jout.state),
                 jax.vmap(jenv.state_index)(jout.state))
        jr = _jax_reset(jenv, jout.state, reset_keys)
        new = jax.tree.map(lambda x, y: jnp.where(
            jout.done.reshape((-1,) + (1,) * (x.ndim - 1)), x, y), jr, jout.state)
        return jout, views, jr, new

    key, k = jax.random.split(key)
    keys = jax.random.split(k, N)
    jstate = jax.vmap(jenv.reset)(keys)
    state = _port_reset(env, None, keys, N)
    _eq_state(state, jstate, "reset")
    done_total = 0
    for s in range(T):
        act = rng.integers(0, 4, N).astype(np.int32)
        key, k1, k2 = jax.random.split(key, 3)
        step_keys, reset_keys = jax.random.split(k1, N), jax.random.split(k2, N)
        jout, (jobs, jboard, jidx), jr, jstate = jax_step(jstate, jnp.asarray(act),
                                                           step_keys, reset_keys)
        draws = _step_draws(env, step_keys)
        a = torch.from_numpy(act)
        out = env.step(state, a) if draws is None else env.step_from_draws(state, a, **draws)
        _eq_state(out.state, jout.state, f"step {s}")
        _eq(out.reward, jout.reward, f"step {s} reward")
        _eq(out.hidden_reward, jout.hidden_reward, f"step {s} hidden")
        _eq(out.done, jout.done, f"step {s} done")
        assert sorted(out.info) == sorted(jout.info)
        for k in jout.info:
            _eq(out.info[k], jout.info[k], f"step {s} info/{k}")
        _eq(env.observe(out.state), jobs, f"step {s} observe")
        _eq(env.board(out.state), jboard, f"step {s} board")
        _eq(env.state_index(out.state), jidx, f"step {s} index")
        r = _port_reset(env, out.state, reset_keys, N)
        _eq_state(r, jr, f"step {s} reset")
        d = out.done
        done_total += int(d.sum())
        state = map_fields(lambda x, y: torch.where(d.reshape((-1,) + (1,) * (x.dim() - 1)),
                                                    x, y), r, out.state)
    assert done_total >= N  # episodes ended (at the latest by the timeout) and reset


@functools.lru_cache(maxsize=None)
def _compiled(alias):
    kw = {"cap": CAP} if alias in FRIENDS else {}
    cenv = make_env(alias, compiled=True, device="cpu", **kw)
    jc = jax_make_env(alias, compiled=True, **kw)
    return cenv, jc


@pytest.mark.parametrize("alias", ALIASES)
def test_compiled_tables_and_step_match_jax(alias):
    cenv, jc = _compiled(alias)
    tabs = tables_to_numpy(cenv)
    for name in ("next_table", "reward_table", "hidden_table", "done_table",
                 "reachable", "obs_table", "board_table"):
        _eq(tabs[name], getattr(jc, name), name)
    assert sorted(cenv.info_tables) == sorted(jc.info_tables)
    for k, v in jc.info_tables.items():
        _eq(tabs[f"info/{k}"], v, f"info/{k}")
    for f in jc.state_store.__dataclass_fields__:
        _eq(getattr(cenv.state_store, f), getattr(jc.state_store, f), f"state_store.{f}")

    # The compiled runtime step with its hooks, on random reachable states.
    n = 256
    rng = np.random.default_rng(1)
    idx = rng.choice(tabs["reachable"], n).astype(np.int32)
    t = rng.integers(0, cenv.max_steps, n).astype(np.int32)
    act = rng.integers(0, cenv.n_actions, n).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    out = cenv.step(TableState(torch.from_numpy(idx), torch.from_numpy(t)),
                    torch.from_numpy(act), draws=_step_draws(cenv.base, keys))
    jout = jax.vmap(jc.step)(JaxTableState(jnp.asarray(idx), jnp.asarray(t)),
                             jnp.asarray(act), keys)
    for name in ("idx", "t"):
        _eq(getattr(out.state, name), getattr(jout.state, name), f"step {name}")
    for name in ("reward", "hidden_reward", "done"):
        _eq(getattr(out, name), getattr(jout, name), f"step {name}")
    if cenv._noisy or cenv._stochastic_index:
        # The hooks changed something for some lanes.
        plain = cenv.step(TableState(torch.from_numpy(idx), torch.from_numpy(t)),
                          torch.from_numpy(act), draws={
                              k: torch.zeros_like(v) for k, v in
                              _step_draws(cenv.base, keys).items()})
        assert not torch.equal(plain.state.idx, out.state.idx)


@pytest.mark.parametrize("alias", ALIASES)
def test_reset_analysis_matches_jax_engines(alias):
    """(mode, r0, r1), the carry tables and the drunk row equal MXUVecEnv's
    key-probed analysis and the JAX stochastic engine's payload row."""
    cenv, jc = _compiled(alias)
    vec = VecEnv(cenv, 4)
    jmx = MXUVecEnv(jc, 1)
    jeng = PallasStochRolloutEngine(jc, 4)
    assert vec.stochastic and jmx._stochastic
    assert vec.mode == jeng._mode
    assert vec.reset_idx_bit == (jeng._r0, jeng._r1)
    if vec.mode:
        assert vec.reset_idx_bit == tuple(jmx.reset_idx_bit)
    else:
        assert vec.reset_idx == jmx.reset_idx
    assert vec.dry_nbits == jeng._dry_nbits and vec.noisy == jeng._noise
    if vec.mode == 2:
        _eq(vec.carry_tab, jmx._carry_tab, "carry tables")
        for b, cand in enumerate((vec.tables.cand0, vec.tables.cand1)):
            _eq(cand, np.asarray(jmx._carry_tab)[b][np.asarray(jc.next_table)], f"cand{b}")
    if vec.noisy:
        S, A, F = vec.S, vec.A, jeng.F
        row = np.asarray(jeng._w, np.float32)[A * F, :S]
        _eq(vec.tables.drunk, row.astype(np.uint8), "drunk row")
        assert int(vec.tables.drunk.sum()) > 0


def test_make_env_builds_each_alias_and_the_friend_substitute():
    for alias in ALIASES:
        env = make_env(alias)
        assert env.num_states is not None
    cenv = make_env("friend", compiled=True, device="cpu", cap=CAP)
    assert isinstance(cenv.base, BoundedFriendFoe) and cenv.base.cap == CAP
    assert cenv.num_states == 35 * 2 * (2 * CAP + 1) == 2170
    assert make_env("tomato", compiled=True, device="cpu").num_states == 1344
    assert make_env("interrupt", compiled=True, device="cpu").num_states == 160
