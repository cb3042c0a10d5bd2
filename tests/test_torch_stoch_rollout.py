"""Stochastic rollout kernel B7: the port's plain version ≡ the JAX Pallas
kernel, bitwise, on identical draw streams.

The JAX kernel runs in Pallas interpret mode on the CPU, as its own tests
run it (``tests/test_stoch_rollout_kernel.py``, N = 64, T = 192); the port's
wrapper takes its plain version for CPU tensors. Every output is exact, so
all 8 per-lane outputs must be equal. The engines' own draw protocols
differ (threefry against ``torch.Generator``), so their statistics are held
to each other at 5σ as the reference holds its kernel to ``MXUVecEnv``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.ops.stoch_rollout_kernel import PallasStochRolloutEngine  # noqa: E402
from safe_grid_agents_torch.convert import engine_state_from_numpy  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv, VecState  # noqa: E402
from safe_grid_agents_torch.ops import stoch_rollout_kernel as srk  # noqa: E402

torch.set_num_threads(1)
ALIASES = ["absent", "interrupt", "whisky", "friend", "neutral", "foe",
           "tomato", "tomato-crmdp"]
NAMES = ["idx", "t", "ep_return", "ep_hidden", "ep_len",
         "reward_acc", "episode_acc", "finished_return_acc"]


@functools.lru_cache(maxsize=None)
def _compiled(alias):
    kw = {"cap": 15} if alias in ("friend", "foe", "neutral") else {}
    return (make_env(alias, compiled=True, device="cpu", **kw),
            jax_make_env(alias, compiled=True, **kw))


def _streams(rng, vec, T, N):
    """Numpy streams in the kernels' layout: actions, bits, stumble, rand_a."""
    actions = rng.integers(0, vec.A, (T, N)).astype(np.int32)
    if vec.dry_nbits:
        dry = rng.random((T, N, vec.dry_nbits)) < 0.05
        bits = (dry.astype(np.int32) << np.arange(vec.dry_nbits)).sum(-1).astype(np.int32)
    else:
        bits = rng.integers(0, 2, (T, N)).astype(np.int32)
    stumble = (rng.random((T, N)) < 0.9).astype(np.int32)
    rand_a = rng.integers(0, vec.A, (T, N)).astype(np.int32)
    return actions, bits, stumble, rand_a


def _assert_outs_equal(outs, jouts, tag):
    for port, ref, name in zip(outs, jouts, NAMES):
        ref = np.asarray(ref)
        port = port.numpy()
        assert port.dtype == ref.dtype, f"{tag} {name}"
        np.testing.assert_array_equal(port, ref, err_msg=f"{tag} {name}")


@pytest.mark.parametrize("alias", ALIASES)
def test_stoch_rollout_plain_matches_pallas_kernel(alias):
    """From a coin reset, then a second chunk from the carried state."""
    N, T = 64, 192
    cenv, jc = _compiled(alias)
    eng = srk.StochRolloutEngine(cenv, N)
    jeng = PallasStochRolloutEngine(jc, N)
    assert (eng.tables.mode, eng.tables.r0, eng.tables.r1) == (jeng._mode, jeng._r0, jeng._r1)
    rng = np.random.default_rng(5)
    coin = rng.integers(0, 2, N)
    idx0 = np.where(coin > 0, eng.tables.r1, eng.tables.r0).astype(np.int32)
    zeros_i, zeros_f = np.zeros(N, np.int32), np.zeros(N, np.float32)
    state = engine_state_from_numpy((idx0, zeros_i, zeros_f, zeros_f, zeros_i), "cpu")
    jstate = tuple(jnp.asarray(x.numpy()) for x in state)
    for chunk in range(2):
        streams = _streams(rng, eng.vec, T, N)
        srk.counts.reset()
        outs = eng.run_streams(state, *(torch.from_numpy(s) for s in streams))
        assert srk.counts.plain_calls == 1 and srk.counts.launches == 0
        jouts = jeng.run_streams(jstate, *(jnp.asarray(s) for s in streams))
        _assert_outs_equal(outs, jouts, f"{alias} chunk {chunk}")
        assert float(outs[6].sum()) >= N  # episodes ended inside the chunk
        state, jstate = outs[:5], jouts[:5]


@pytest.mark.parametrize("alias", ["absent", "whisky", "friend", "tomato"])
def test_stoch_engine_stats_consistent_with_mxu_engine(alias):
    """Different draw protocols, the same distributions: the mean finished
    return per episode of a long random rollout agrees with the JAX
    ``MXUVecEnv`` within 5σ (tests/test_stoch_rollout_kernel.py:106-129)."""
    N, T = 256, 512
    cenv, jc = _compiled(alias)
    eng = srk.StochRolloutEngine(cenv, N)
    g = torch.Generator().manual_seed(0)
    _, acc_k = eng.run_random_reduced(eng.reset(g), g, T)
    mxu = MXUVecEnv(jc, N)
    _, acc_m = jax.jit(mxu.run_random_reduced, static_argnums=2)(
        mxu.reset(jax.random.PRNGKey(2)), jax.random.PRNGKey(3), T)
    n_k, n_m = float(acc_k["episodes"]), float(acc_m["episodes"])
    assert n_k > 100 and n_m > 100, (alias, n_k, n_m)
    m_k = float(acc_k["finished_return_sum"]) / n_k
    m_m = float(acc_m["finished_return_sum"]) / n_m
    sigma = 150.0 / np.sqrt(min(n_k, n_m))
    assert abs(m_k - m_m) < 5 * sigma, (alias, m_k, m_m, sigma)


@pytest.mark.parametrize("alias", ALIASES)
def test_vec_step_matches_one_plain_kernel_step(alias):
    """``VecEnv.step`` on the same draws ≡ one step of B7's plain version,
    from random reachable lanes mid-episode."""
    N = 256
    cenv, _ = _compiled(alias)
    vec = VecEnv(cenv, N)
    rng = np.random.default_rng(3)
    reach = cenv.reachable.numpy()
    lanes = (rng.choice(reach, N).astype(np.int32), rng.integers(0, 100, N).astype(np.int32),
             rng.integers(-30, 5, N).astype(np.float32),
             rng.integers(-30, 5, N).astype(np.float32),
             rng.integers(0, 60, N).astype(np.int32))
    state = engine_state_from_numpy(lanes, "cpu")
    streams = [torch.from_numpy(s) for s in _streams(rng, vec, 1, N)]
    outs = srk.stoch_rollout_reference(vec.tables, state, *streams)
    vs, out = vec.step(VecState(*(x[0] for x in state)), streams[0][0],
                       tuple(s[0] for s in streams[1:]))
    for got, want in zip((vs.idx, vs.t, vs.ep_return, vs.ep_hidden, vs.ep_len), outs[:5]):
        assert torch.equal(got, want[0])
    assert torch.equal(out["reward"], outs[5][0])
    assert torch.equal(out["done"].to(torch.float32), outs[6][0])
    assert torch.equal(torch.where(out["done"], out["finished_return"],
                                   torch.zeros_like(out["reward"])), outs[7][0])
    assert bool(out["done"].any())


@pytest.mark.parametrize("alias", ["absent", "whisky", "tomato", "friend"])
def test_stoch_engine_draw_protocol(alias):
    """The streams hold what the kernels read: coins for coin and carried
    resets, tomato's five dry coins packed little-endian (each at 0.05),
    whisky's stumble at 0.9; a stream the env does not use is zeros."""
    cenv, _ = _compiled(alias)
    eng = srk.StochRolloutEngine(cenv, 512)
    g = torch.Generator().manual_seed(0)
    actions, bits, stumble, rand_a = eng.draw_streams(g, 64)
    assert all(x.dtype == torch.int32 and x.shape == (64, 512)
               for x in (actions, bits, stumble, rand_a))
    assert int(actions.min()) >= 0 and int(actions.max()) < eng.A
    if eng.tables.dry_nbits:
        assert int(bits.min()) >= 0 and int(bits.max()) < 32
        for k in range(5):
            assert abs(float(((bits >> k) & 1).float().mean()) - 0.05) < 0.01
    else:
        assert bits.unique().tolist() == ([0, 1] if eng.tables.mode else [0])
        if eng.tables.mode:
            assert abs(float(bits.float().mean()) - 0.5) < 0.02
    if eng.tables.noise:
        assert abs(float(stumble.float().mean()) - 0.9) < 0.01
        assert rand_a.unique().tolist() == [0, 1, 2, 3]
    else:
        assert not stumble.any() and not rand_a.any()
    assert torch.equal(eng.draw_bits(torch.Generator().manual_seed(3), 8),
                       eng.vec.draw_mechanics(torch.Generator().manual_seed(3), 8)[0])


def test_stoch_engine_rejections():
    with pytest.raises(ValueError, match="deterministic"):
        srk.StochRolloutEngine(make_env("shift", compiled=True, device="cpu"), 8)
    cenv, _ = _compiled("tomato")
    eng = srk.StochRolloutEngine(cenv, 8)
    bad = dataclasses.replace(eng.tables, mode=1)
    z = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="drying"):
        srk.stoch_rollout(bad, eng.reset(), z, z, z, z)
    with pytest.raises(ValueError, match="stumble"):
        srk.stoch_rollout(eng.tables, eng.reset(), z, z, z.to(torch.int64), z)
    # The deterministic engine refuses stochastic envs in turn.
    from safe_grid_agents_torch.ops.rollout_kernel import RolloutEngine
    with pytest.raises(ValueError, match="StochRolloutEngine"):
        RolloutEngine(make_env("absent", compiled=True, device="cpu"), 8)
