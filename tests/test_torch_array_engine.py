"""The array engine (``envs/array_vec.py::ArrayVecEnv``) against the JAX
package's ``envs/vec.py::VecEnv``, on all 19 aliases.

The same ``[T, N]`` actions go through both engines from the same lanes.
The JAX engine splits each lane's key every step into a step key, a reset
key and the next key; the port takes the numbers those keys give as
handed-over draws (the reset coin ``bernoulli(k_reset, 0.5)``; whisky's
``split`` into the stumble coin and the random action; tomato's ``[K]``
dry vector), so every output must be equal: rewards, dones, infos, the
``finished_*`` statistics, the lanes' states after the auto-reset and the
pre-reset successors. Every value is exact (small integers, integer or
half-integer rewards).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.vec import VecEnv as JaxVecEnv  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.array_vec import ArrayVecEnv  # noqa: E402

torch.set_num_threads(1)
DETERMINISTIC = ["shift", "shift-test", "island", "sokoban", "sokoban2", "boat", "conveyor",
                 "conveyor-sushi", "corners", "way", "toy"]
STOCHASTIC = ["absent", "interrupt", "whisky", "tomato", "tomato-crmdp", "friend", "foe",
              "neutral"]
N, T = 24, 110  # T crosses the 100-step timeout


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(port, ref, what):
    port, ref = _np(port), np.asarray(ref)
    assert port.dtype == ref.dtype, f"{what}: dtype {port.dtype} vs {ref.dtype}"
    np.testing.assert_array_equal(port, ref, err_msg=what)


def _eq_state(port, ref, what):
    for f in ref.__dataclass_fields__:
        _eq(getattr(port, f), getattr(ref, f), f"{what} {f}")


@jax.jit
def _split3(keys):
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    return ks[:, 0], ks[:, 1], ks[:, 2]


_coins = jax.jit(jax.vmap(lambda k: jax.random.bernoulli(k, 0.5)))


@jax.jit
def _whisky_draws(keys):
    ks = jax.vmap(jax.random.split)(keys)
    return (jax.vmap(lambda k: jax.random.bernoulli(k, 0.9))(ks[:, 0]),
            jax.vmap(lambda k: jax.random.randint(k, (), 0, 4))(ks[:, 1]))


@jax.jit
def _dry(keys, like):
    return jax.vmap(lambda k: jax.random.bernoulli(k, 0.05, like.shape))(keys)


def step_draws(vec, keys):
    """The port's draws for one step of the JAX engine whose lanes hold
    ``keys`` (and the next keys)."""
    k_step, k_reset, k_next = _split3(keys)
    base = getattr(vec.env, "base", vec.env)
    d = {}
    if vec.coin_reset:
        d["coin"] = torch.from_numpy(np.asarray(_coins(k_reset)).astype(np.int32))
    if hasattr(base, "noisy_action"):
        stumble, rand = _whisky_draws(k_step)
        d["stumble"] = torch.from_numpy(np.array(stumble))
        d["rand_action"] = torch.from_numpy(np.array(rand))
    if hasattr(base, "stochastic_index"):
        d["dry"] = torch.from_numpy(np.array(_dry(k_step, jnp.zeros(base.n_tomatoes))))
    return d, k_next


def reset_pair(vec, jvec, key):
    """Both engines' fresh lanes from one JAX key (the port takes the coins
    the JAX reset draws)."""
    jvs = jvec.reset(key)
    keys = jax.random.split(key, N)
    init = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
    coin = None
    if vec.coin_reset:
        coin = torch.from_numpy(np.asarray(_coins(init[:, 0])).astype(np.int32))
    return vec.reset(coin=coin), jvs


def port_draws(vec, jvs, n_steps):
    """T per-step draw dicts along the JAX lanes' key chain."""
    keys, draws = jvs.key, []
    for _ in range(n_steps):
        d, keys = step_draws(vec, keys)
        draws.append(d)
    return draws


def engines(alias, compiled=False):
    kw = {"cap": 15} if compiled and alias in ("friend", "foe", "neutral") else {}
    env = make_env(alias, compiled=compiled, **({"device": "cpu"} if compiled else {}), **kw)
    jenv = jax_make_env(alias, compiled=compiled, **kw)
    return ArrayVecEnv(env, N, device="cpu"), JaxVecEnv(jenv, N)


def _check_run(alias, compiled=False):
    vec, jvec = engines(alias, compiled)
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(3))
    _eq_state(vs.env, jvs.env, "reset")
    rng = np.random.default_rng(7)
    acts = rng.integers(0, vec.env.n_actions, (T, N)).astype(np.int32)
    draws = port_draws(vec, jvs, T) if vec.stochastic else None
    jvs2, jouts = jax.jit(jvec.run_actions)(jvs, jnp.asarray(acts))
    vs2, outs = vec.run_actions(vs, torch.from_numpy(acts), draws)
    for k in ("reward", "hidden_reward", "done", "finished_return", "finished_hidden",
              "finished_len"):
        _eq(outs[k], getattr(jouts, k), k)
    assert sorted(outs["info"]) == sorted(jouts.info)
    for k, v in jouts.info.items():
        _eq(outs["info"][k], v, f"info/{k}")
    _eq_state(outs["pre_reset_env"], jouts.pre_reset_env, "pre-reset successors")
    _eq_state(vs2.env, jvs2.env, "final lanes")
    for k in ("ep_return", "ep_hidden", "ep_len"):
        _eq(getattr(vs2, k), getattr(jvs2, k), k)
    _eq(vec.observe(vs2), jvec.observe(jvs2), "observe")
    _eq(vec.board(vs2), jvec.board(jvs2), "board")
    _eq(vec.state_index(vs2), jvec.state_index(jvs2), "state_index")
    assert np.asarray(jouts.done).any(axis=0).all(), "every lane ends an episode in the run"
    return vec


@pytest.mark.parametrize("alias", DETERMINISTIC)
def test_run_actions_matches_jax_on_deterministic_aliases(alias):
    _check_run(alias)


@pytest.mark.parametrize("alias", STOCHASTIC)
def test_run_actions_matches_jax_on_the_jax_engines_draws(alias):
    assert _check_run(alias).stochastic


@pytest.mark.parametrize("alias", ["whisky", "friend"])
def test_run_actions_matches_jax_on_a_compiled_env(alias):
    """``--compiled`` without ``--mxu``: the same engine over a
    ``CompiledEnv``, its coin resets and step draws as indices."""
    _check_run(alias, compiled=True)


@pytest.mark.parametrize("alias", ["shift", "sokoban", "friend", "whisky"])
def test_run_random_reduced_totals_match_jax(alias):
    vec, jvec = engines(alias)
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(5))
    key, n_steps = jax.random.PRNGKey(9), 130
    acts, k = [], key
    for _ in range(n_steps):
        k, ka = jax.random.split(k)
        acts.append(np.asarray(jax.random.randint(ka, (N,), 0, vec.env.n_actions)))
    acts = torch.from_numpy(np.stack(acts).astype(np.int32))
    _, jacc = jax.jit(jvec.run_random_reduced, static_argnums=2)(jvs, key, n_steps)
    if vec.stochastic:
        draws = port_draws(vec, jvs, n_steps)
        # run_random_reduced draws from a generator; on handed-over draws it
        # is run_actions reduced, which is what this compares.
        _, outs = vec.run_actions(vs, acts, draws)
        d = outs["done"]
        acc = {"reward_sum": outs["reward"].sum(), "episodes": d.sum(dtype=torch.int32),
               "finished_return_sum": torch.where(d, outs["finished_return"], 0.0).sum()}
    else:
        _, acc = vec.run_random_reduced(vs, None, n_steps, actions=acts)
    for k in ("reward_sum", "episodes", "finished_return_sum"):
        _eq(acc[k], jacc[k], k)
    assert int(acc["episodes"]) > 0


def test_pre_reset_successor_on_a_timeout():
    """A lane standing still on shift times out at step 100 inside the run:
    the step reports the pre-reset successor, and the lane restarts."""
    vec = ArrayVecEnv(make_env("shift"), 2, device="cpu")
    vs = vec.reset()
    start = vec.state_index(vs)
    up = torch.zeros((101, 2), dtype=torch.int32)   # UP walks into the top wall
    _, outs = vec.run_actions(vs, up)
    done = outs["done"]
    assert not done[:99].any() and done[99].all()
    assert outs["finished_len"][99].tolist() == [100, 100]
    pre = vec.env.state_index(outs["pre_reset_env"])
    assert torch.equal(pre[99], start) and torch.equal(outs["pre_reset_env"].t[99],
                                                       torch.tensor([100, 100], dtype=torch.int32))


def test_vec_state_converts_from_the_jax_engine():
    vec, jvec = engines("friend")
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(1))
    jvs, _ = jax.jit(jvec.run_actions)(jvs, jnp.ones((7, N), jnp.int32))
    port = convert.array_vec_state_from_jax(
        type(vs.env), {f: np.asarray(getattr(jvs.env, f)) for f in jvs.env.__dataclass_fields__},
        np.asarray(jvs.ep_return), np.asarray(jvs.ep_hidden), np.asarray(jvs.ep_len), "cpu")
    _eq_state(port.env, jvs.env, "env")
    back = convert.array_vec_state_to_numpy(port)
    for f, v in back[0].items():
        _eq(v, getattr(jvs.env, f), f)
    for got, want in zip(back[1:], (jvs.ep_return, jvs.ep_hidden, jvs.ep_len)):
        _eq(got, want, "episode accounting")


@pytest.mark.parametrize("alias", ["shift", "whisky"])
def test_run_random_reduces_to_run_random_reduced(alias):
    """``run_random``'s stacked outputs, reduced, are ``run_random_reduced``'s
    totals on the same generator stream (actions, then the env's draws)."""
    vec = ArrayVecEnv(make_env(alias), N, device="cpu")
    vs, outs = vec.run_random(vec.reset(), torch.Generator().manual_seed(3), 120)
    vs2, acc = vec.run_random_reduced(vec.reset(), torch.Generator().manual_seed(3), 120)
    d = outs["done"]
    assert outs["reward"].shape == (120, N) and int(d.sum()) == int(acc["episodes"]) > 0
    assert float(outs["reward"].sum()) == float(acc["reward_sum"])
    assert float(torch.where(d, outs["finished_return"], 0.0).sum()) == float(
        acc["finished_return_sum"])
    for f in ("pos", "t"):
        assert torch.equal(getattr(vs.env, f), getattr(vs2.env, f))
