"""Stochastic fused tabular-Q kernel B8, its trainer and its CLI path.

The port's plain B8 is held against the JAX Pallas kernel
``tabq_stoch_run`` (interpret mode on the CPU, as its own tests run it) on
the same Q0, lanes and five streams, and against the numpy host replays of
``tests/test_tabular_kernel.py`` (tomato :100-156, whisky :179-244).
Tolerances: Q to atol 1e-4 — the TD sums are taken in another order (the
JAX kernel's lane-contraction matmul, the port's ``index_add_``), the
reference's own tolerance; every other output must be equal. The trainer
and the CLI are gated on the reference's outcomes (RESULTS.md:18-22).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.agents.tabular import TabularQAgent as JaxTabularQAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.ops.tabular_stoch_kernel import tabq_stoch_run  # noqa: E402
from safe_grid_agents_tpu.training.tabular_pallas import PallasTabularQTrainer  # noqa: E402
from safe_grid_agents_torch.agents.tabular import TabularQAgent  # noqa: E402
from safe_grid_agents_torch.cli.main import run  # noqa: E402
from safe_grid_agents_torch.convert import (  # noqa: E402
    engine_state_from_numpy, q_from_kernel_layout, q_to_kernel_layout,
)
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.ops import tabular_stoch_kernel as tsk  # noqa: E402
from safe_grid_agents_torch.training import FusedTabularQTrainer, stats_to_host  # noqa: E402

torch.set_num_threads(1)
HYPER = dict(lr=0.1, epsilon=0.6, epsilon_anneal_steps=10_000)
NAMES = ["idx", "t", "ep_return", "ep_hidden", "ep_len", None,
         "episodes", "return_acc", "hidden_acc", "length_acc"]


@functools.lru_cache(maxsize=None)
def _compiled(alias):
    kw = {"cap": 15} if alias in ("friend", "foe", "neutral") else {}
    return (make_env(alias, compiled=True, device="cpu", **kw),
            jax_make_env(alias, compiled=True, **kw))


def _trainer(alias, n, **hyper):
    cenv, _ = _compiled(alias)
    return FusedTabularQTrainer(TabularQAgent(cenv, **{**HYPER, **hyper}), VecEnv(cenv, n))


def _streams(rng, vec, T, N):
    """Numpy streams: rand_a, u, bits, stumble, rand2."""
    rand_a = rng.integers(0, vec.A, (T, N)).astype(np.int32)
    u = rng.random((T, N), dtype=np.float32)
    if vec.dry_nbits:
        dry = rng.random((T, N, vec.dry_nbits)) < 0.05
        bits = (dry.astype(np.int32) << np.arange(vec.dry_nbits)).sum(-1).astype(np.int32)
    else:
        bits = rng.integers(0, 2, (T, N)).astype(np.int32)
    stumble = (rng.random((T, N)) < 0.9).astype(np.int32)
    rand2 = rng.integers(0, vec.A, (T, N)).astype(np.int32)
    return rand_a, u, bits, stumble, rand2


@pytest.mark.parametrize("alias", ["whisky", "tomato", "absent", "friend", "interrupt", "foe"])
def test_tabq_stoch_plain_matches_pallas_kernel(alias):
    N, T = 32, 64
    tr = _trainer(alias, N)
    _, jc = _compiled(alias)
    jtr = PallasTabularQTrainer(JaxTabularQAgent(jc, **HYPER), MXUVecEnv(jc, N))
    assert jtr._stochastic and tr.stochastic
    rng = np.random.default_rng(0)
    q0 = rng.normal(0.0, 1.0, (tr.S, tr.A)).astype(np.float32)
    reach = tr.vec.cenv.reachable.numpy()
    lanes = (rng.choice(reach, N).astype(np.int32), rng.integers(0, 100, N).astype(np.int32),
             rng.integers(-20, 5, N).astype(np.float32),
             rng.integers(-20, 5, N).astype(np.float32),
             rng.integers(0, 40, N).astype(np.int32))
    streams = _streams(rng, tr.vec, T, N)
    step0 = 3_000

    tsk.counts.reset()
    outs = tsk.tabq_stoch(tr.tables, tr.hyper, torch.from_numpy(q0),
                          engine_state_from_numpy(lanes, "cpu"),
                          torch.tensor([step0], dtype=torch.int64),
                          *(torch.from_numpy(s) for s in streams))
    assert tsk.counts.plain_calls == 1 and tsk.counts.launches == 0
    jouts = tabq_stoch_run(
        jtr._static_stoch, jtr._w_stoch,
        jnp.asarray(q_to_kernel_layout(q0, jtr.A_pad, jtr.S_pad)),
        tuple(jnp.asarray(x).reshape(1, N) for x in lanes),
        jnp.full((1, 1), step0, jnp.int32), *(jnp.asarray(s) for s in streams),
    )
    jq = q_from_kernel_layout(np.asarray(jouts[0]), tr.S, tr.A, "cpu")
    torch.testing.assert_close(outs[0], jq, rtol=0.0, atol=1e-4)
    assert int(outs[6][0]) == int(np.asarray(jouts[6])[0, 0]) == step0 + T * N
    for i, name in enumerate(NAMES, start=1):
        if name is not None:
            np.testing.assert_array_equal(outs[i].numpy(), np.asarray(jouts[i]),
                                          err_msg=f"{alias} {name}")
    assert float(outs[7].sum()) > 0  # episodes ended inside the chunk


def _host_replay(tr, streams, T, N):
    """tests/test_tabular_kernel.py's numpy replay of the five-stream
    protocol from zero Q and a fresh reset: act and learn on the CHOSEN
    action at the observed (pre-dry) index; the env steps the DRIED index on
    the EFFECTIVE action."""
    rand_a, u, bits, stumble, rand2 = streams
    agent, vec = tr.agent, tr.vec
    tab = vec.tables
    nxt_t, rew_t = tab.next.numpy(), tab.reward.numpy()
    done_t = tab.done.numpy().astype(bool)
    drunk = None if tab.drunk is None else tab.drunk.numpy().astype(bool)
    mask = 2 ** tab.dry_nbits - 1
    q = np.zeros((vec.S, vec.A), np.float32)
    idx = np.full((N,), vec.reset_idx, np.int64)
    t = np.zeros((N,), np.int64)
    step, episodes = 0, 0.0
    for s in range(T):
        frac = min(max(step / agent.epsilon_anneal_steps, 0.0), 1.0)
        eps = agent.epsilon + frac * (agent.epsilon_final - agent.epsilon)
        a = np.where(u[s] < eps, rand_a[s], q[idx].argmax(-1))          # chosen
        dried = idx - (idx & mask & bits[s]) if tab.dry_nbits else idx
        eff = a if drunk is None else np.where(drunk[dried] & (stumble[s] > 0), rand2[s], a)
        nxt, r = nxt_t[dried, eff], rew_t[dried, eff]
        done = done_t[dried, eff] | (t + 1 >= vec.max_steps)
        td = r + agent.discount * np.where(done, 0.0, q[nxt].max(-1)) - q[idx, a]
        td_sum, cnt = np.zeros_like(q), np.zeros_like(q)
        np.add.at(td_sum, (idx, a), td)
        np.add.at(cnt, (idx, a), 1.0)
        q = q + agent.lr * td_sum / np.maximum(cnt, 1.0)
        episodes += done.sum()
        idx = np.where(done, vec.reset_idx, nxt)
        t = np.where(done, 0, t + 1)
        step += N
    return q, idx, episodes


@pytest.mark.parametrize("alias", ["tomato", "whisky"])
def test_tabq_stoch_plain_matches_host_replay(alias):
    N, T = 32, 64
    tr = _trainer(alias, N)
    streams = _streams(np.random.default_rng(5), tr.vec, T, N)
    astate, vstate = tr.init()
    outs = tsk.tabq_stoch(tr.tables, tr.hyper, astate.q, vstate, astate.step.reshape(1),
                          *(torch.from_numpy(s) for s in streams))
    q, idx, episodes = _host_replay(tr, streams, T, N)
    np.testing.assert_allclose(outs[0].numpy(), q, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(outs[1].numpy()[0], idx)
    assert float(outs[7].sum()) == episodes


def _train(alias, chunks, eval_steps, seed=1, **hyper):
    tr = _trainer(alias, 64, lr=0.2, epsilon=1.0, **hyper)
    g = torch.Generator().manual_seed(seed)
    astate, vstate = tr.init(g)
    tsk.counts.reset()
    for _ in range(chunks):
        astate, vstate, _ = tr.train_chunk(astate, vstate, g, 128)
    assert tsk.counts.plain_calls == chunks and tsk.counts.launches == 0
    assert int(astate.step) == chunks * 128 * 64
    _, es = tr.eval_chunk(astate, tr.vec.reset(g), eval_steps, generator=g)
    return stats_to_host(es)


def test_fused_trainer_learns_tomato_bucket_hack():
    """tabular-q camps on the observation-corrupting bucket: observed ≫
    hidden (RESULTS.md ~177/25; tests/test_tabular_kernel.py:159-176)."""
    s = _train("tomato", 16, 120, epsilon_anneal_steps=40_000)
    assert s["mean_return"] > 100.0, s
    assert s["mean_hidden"] < s["mean_return"] - 50.0, s


def test_fused_trainer_learns_whisky_sober_detour():
    """whisky's sober-detour optimum is 43 (tests/test_tabular_kernel.py:247-262)."""
    s = _train("whisky", 12, 40, epsilon_anneal_steps=30_000)
    assert s["mean_return"] > 38.0, s


def test_fused_trainer_learns_absent_supervisor_split():
    """The punished shortcut only while the supervisor is away: observed ≈44,
    hidden below it (tests/test_tabular_kernel.py:265-283)."""
    s = _train("absent", 16, 60, epsilon_anneal_steps=40_000)
    assert s["mean_return"] > 40.0, s
    assert s["mean_hidden"] < s["mean_return"] - 5.0, s


def test_fused_trainer_refuses_ragged_chunks_and_wide_batches():
    tr = _trainer("absent", 8)
    astate, vstate = tr.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of 32"):
        tr.train_chunk(astate, vstate, torch.Generator().manual_seed(0), 48)
    cenv, _ = _compiled("absent")
    with pytest.raises(ValueError, match="4096"):
        FusedTabularQTrainer(TabularQAgent(cenv), VecEnv(cenv, 4097))


ABSENT_CLI = ["absent", "tabular-q", "--compiled", "--mxu", "--fused-kernel",
              "--n-envs", "64", "--steps", "120000", "--chunk-steps", "128",
              "--eval-every", "4", "--eval-steps", "60", "--lr", "0.2",
              "--epsilon-anneal-steps", "40000", "--platform", "cpu"]


def test_cli_absent_supervisor_split(tmp_path):
    """The reference's own CLI test (tests/test_cli.py:539-553) on the port."""
    tsk.counts.reset()
    stats = run(ABSENT_CLI + ["--log-dir", str(tmp_path)])
    assert stats["mean_return"] > 40.0, stats
    assert stats["mean_hidden"] < stats["mean_return"] - 5.0, stats
    # 120000 // (128 · 64) = 14 chunks, each one call of B8's plain version.
    assert tsk.counts.plain_calls == 14 and tsk.counts.launches == 0


def test_cli_eval_env_accepts_a_stochastic_alias():
    """--eval-env takes the stochastic aliases: train on tomato, evaluate
    greedily on tomato-crmdp (the same dynamics and index space), drawing
    the eval's dry coins from the run's generator."""
    stats = run(["tomato", "tabular-q", "--compiled", "--mxu", "--fused-kernel",
                 "--n-envs", "16", "--steps", "4096", "--chunk-steps", "64",
                 "--eval-steps", "100", "--eval-env", "tomato-crmdp", "--platform", "cpu"])
    assert stats["episodes"] == 16 and stats["mean_length"] == 100.0, stats
    assert stats["mean_hidden"] <= stats["mean_return"], stats


@pytest.mark.parametrize("argv, match", [
    (["friend", "tabular-q", "--compiled", "--mxu", "--fused-kernel"], "hidden reward box"),
    (["neutral", "tabular-q", "--compiled"], "hidden reward box"),
    (["tomato", "ppo-mlp", "--compiled", "--mxu", "--fused-kernel"], "requires --table-net"),
    (["absent", "deep-q", "--preset", "--compiled", "--mxu", "--fused-kernel"],
     "--warmup-steps 40 must be a multiple of 16"),
])
def test_cli_refuses_friend_tabular_and_stochastic_deep_agents(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + ["--platform", "cpu"])
