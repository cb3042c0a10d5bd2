"""Stochastic fused PPO collect kernel B10, the PPO trainers' stochastic
branches and their CLI paths.

The port's plain B10 is held against the JAX Pallas kernel
``ppo_stoch_collect_run`` (interpret mode on the CPU, as its own tests run
it) on the same lanes, four streams and policy rows — the rows inside the
JAX trainer's own ``_collect_payload`` of a table net, whose params, carried
across by ``convert``, give the port's rows to atol 1e-6: every output must
be equal, because every recorded float is a gather. Then the gates of
``tests/test_ppo_stoch_collect_kernel.py``: the numpy host replay (bitwise),
the fused collect against the ``MXUPPOTrainer`` collect at 5σ, and a
composed train chunk; and the reference's CLI test of the path
(``tests/test_cli.py:452-475``).
"""
import functools
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.ops.ppo_stoch_collect_kernel import ppo_stoch_collect_run  # noqa: E402
from safe_grid_agents_tpu.training.ppo_pallas import PallasPPOTrainer  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.ppo import PPOAgent  # noqa: E402
from safe_grid_agents_torch.cli.main import run  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.ops import ppo_collect_kernel as pck  # noqa: E402
from safe_grid_agents_torch.ops import ppo_kernel as pk  # noqa: E402
from safe_grid_agents_torch.ops import ppo_stoch_collect_kernel as psk  # noqa: E402
from safe_grid_agents_torch.training import (  # noqa: E402
    FusedPPOTrainer, MXUPPOTrainer, stats_to_host,
)

torch.set_num_threads(1)
ALIASES = ["absent", "interrupt", "whisky", "tomato", "neutral", "foe"]
NAMES = ["idx", "t", "ep_return", "ep_hidden", "ep_len", "episodes", "return_acc",
         "hidden_acc", "length_acc", "pre_idx", "pre_t", "action", "logp", "value",
         "reward", "hidden", "done", "next_idx"]


@functools.lru_cache(maxsize=None)
def _compiled(alias):
    kw = {"cap": 15} if alias in ("friend", "foe", "neutral") else {}
    return (make_env(alias, compiled=True, device="cpu", **kw),
            jax_make_env(alias, compiled=True, **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _streams(rng, vec, T, N):
    """Numpy streams: u, bits, stumble, rand_a."""
    u = rng.random((T, N), dtype=np.float32)
    if vec.dry_nbits:
        dry = rng.random((T, N, vec.dry_nbits)) < 0.05
        bits = (dry.astype(np.int32) << np.arange(vec.dry_nbits)).sum(-1).astype(np.int32)
    else:
        bits = rng.integers(0, 2, (T, N)).astype(np.int32)
    stumble = (rng.random((T, N)) < 0.9).astype(np.int32)
    rand_a = rng.integers(0, vec.A, (T, N)).astype(np.int32)
    return u, bits, stumble, rand_a


def _lanes(rng, vec, N, start):
    if start == "reset":
        idx = rng.choice(np.array(vec.reset_idx_bit), N).astype(np.int32)
        return (idx, np.zeros(N, np.int32), np.zeros(N, np.float32),
                np.zeros(N, np.float32), np.zeros(N, np.int32))
    reach = vec.cenv.reachable.numpy()
    return (rng.choice(reach, N).astype(np.int32),
            rng.integers(0, vec.max_steps, N).astype(np.int32),
            rng.integers(-20, 5, N).astype(np.float32),
            rng.integers(-20, 5, N).astype(np.float32),
            rng.integers(0, 40, N).astype(np.int32))


def _payload_rows(jtr, payload, S, A):
    """The policy rows inside the reference's stochastic collect payload:
    after the A·F env rows and the drunk row (whisky)."""
    w = np.asarray(payload)
    lp0 = A * jtr._seng.F + (1 if jtr._seng._noise else 0)
    return pck.PolicyRows(
        logp=torch.from_numpy(np.ascontiguousarray(w[lp0:lp0 + A, :S].T)),
        cdf=torch.from_numpy(np.ascontiguousarray(w[lp0 + A:lp0 + 2 * A - 1, :S].T)),
        value=torch.from_numpy(np.array(w[lp0 + 2 * A - 1, :S])))


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize("start", ["reset", "mid"])
def test_ppo_stoch_collect_plain_matches_pallas_kernel(alias, start):
    N, T = 32, 32
    cenv, jc = _compiled(alias)
    vec = VecEnv(cenv, N)
    jagent = JaxPPOAgent(jc, net="table")
    jtr = PallasPPOTrainer(jagent, MXUVecEnv(jc, N))
    assert jtr._stoch_collect and vec.stochastic
    params = jagent.init(jax.random.PRNGKey(len(alias))).params
    payload = jtr._collect_payload(params)
    rows = _payload_rows(jtr, payload, vec.S, vec.A)
    # The port's rows of the same params, carried across, agree to atol 1e-6.
    tr = FusedPPOTrainer(PPOAgent(cenv, net="table"), vec)
    own = tr.policy_rows(convert.ac_params_from_flax(_np_tree(params), "cpu"))
    for f in ("logp", "cdf", "value"):
        np.testing.assert_allclose(getattr(own, f).numpy(), getattr(rows, f).numpy(),
                                   atol=1e-6, err_msg=f)
    rng = np.random.default_rng(abs(hash((alias, start))) % 2**32)
    lanes = _lanes(rng, vec, N, start)
    streams = _streams(rng, vec, T, N)
    jouts = ppo_stoch_collect_run(jtr._cstatic, payload,
                                  tuple(jnp.asarray(x).reshape(1, N) for x in lanes),
                                  *(jnp.asarray(s) for s in streams))
    psk.counts.reset()
    outs = psk.ppo_stoch_collect(tr.tables, rows, convert.engine_state_from_numpy(lanes, "cpu"),
                                 *(torch.from_numpy(s) for s in streams))
    assert psk.counts.plain_calls == 1 and psk.counts.launches == 0
    assert len(outs) == len(jouts) == len(NAMES)
    for name, a, b in zip(NAMES, outs, jouts):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=f"{alias} {start} {name}")
    assert len(np.unique(outs[11].numpy())) == vec.A
    if start == "mid":
        assert float(outs[5].sum()) > 0  # episodes ended inside the chunk


@pytest.mark.parametrize("alias", ALIASES)
def test_ppo_stoch_collect_matches_host_replay(alias):
    """``FusedPPOTrainer.collect`` against the numpy replay of the four-
    stream protocol (tests/test_ppo_stoch_collect_kernel.py:34-111):
    inverse-CDF acting on the policy rows at the PRE-dry index, the CHOSEN
    action and its logp in the records, whisky's noise on the EFFECTIVE
    action, coin and carried resets, the env stepped at the DRIED index."""
    cenv, _ = _compiled(alias)
    N, T = 64, 128  # past the 100-step timeout: every lane resets at least once
    tr = FusedPPOTrainer(PPOAgent(cenv, net="table"), VecEnv(cenv, N))
    g = torch.Generator().manual_seed(9)
    astate, vstate = tr.init(seed=0, generator=g)
    u, bits, stumble, rand_a = _streams(np.random.default_rng(3), tr.vec, T, N)
    vstate2, stats, traj = tr.collect(astate, vstate, torch.from_numpy(u), tuple(
        torch.from_numpy(x) for x in (bits, stumble, rand_a)))
    rows = tr.policy_rows(astate.params)
    logp_t, cdf_t, val_t = (getattr(rows, f).numpy() for f in ("logp", "cdf", "value"))
    tab = tr.vec.tables
    nxt_t, rew_t, hid_t = tab.next.numpy(), tab.reward.numpy(), tab.hidden.numpy()
    done_t = tab.done.numpy().astype(bool)
    drunk = None if tab.drunk is None else tab.drunk.numpy().astype(bool)
    carry = tr.vec.carry_tab.numpy() if tab.mode == 2 else None
    idx = vstate.idx.numpy().astype(np.int64)
    t = np.zeros(N, np.int64)
    episodes = 0.0
    for s in range(T):
        a = (u[s][:, None] >= cdf_t[idx]).sum(-1)                     # chosen, pre-dry
        env_idx = idx - (idx & (2 ** tab.dry_nbits - 1) & bits[s]) if tab.dry_nbits else idx
        eff = a if drunk is None else np.where(drunk[env_idx] & (stumble[s] > 0), rand_a[s], a)
        nx = nxt_t[env_idx, eff]
        done = done_t[env_idx, eff] | (t + 1 >= tab.max_steps)
        for name, got, want in (
                ("states", traj["states"].idx, idx), ("t", traj["states"].t, t),
                ("actions", traj["actions"], a), ("old_logp", traj["old_logp"], logp_t[idx, a]),
                ("values", traj["values"], val_t[idx]),
                ("rewards", traj["rewards"], rew_t[env_idx, eff]),
                ("observed", traj["observed"], rew_t[env_idx, eff]),
                ("hidden", traj["hidden"], hid_t[env_idx, eff]),
                ("dones", traj["dones"], done), ("next_idx", traj["next_idx"], nx)):
            np.testing.assert_array_equal(got[s].numpy(), want,
                                          err_msg=f"{alias} step {s}: {name}")
        episodes += done.sum()
        if tab.mode == 1:
            reset = np.where(bits[s] > 0, tab.r1, tab.r0)
        elif tab.mode == 2:
            reset = carry[bits[s], nx]
        else:
            reset = np.full(N, tab.r0)
        idx = np.where(done, reset, nx)
        t = np.where(done, 0, t + 1)
    np.testing.assert_array_equal(vstate2.idx.numpy(), idx)
    assert float(stats.episodes) == episodes and episodes > 0


def test_ppo_stoch_collect_stats_consistent_with_mxu_collect():
    """The same fresh params, two draw protocols: the mean finished return
    per episode of the fused collect (B10's plain version) agrees with the
    ``MXUPPOTrainer`` collect at 5σ over a long chunk (absent, N = 256,
    T = 512; tests/test_ppo_stoch_collect_kernel.py:114-136)."""
    cenv, _ = _compiled("absent")
    N, T = 256, 512

    def build(cls, seed):
        tr = cls(PPOAgent(cenv, net="table"), VecEnv(cenv, N))
        g = torch.Generator().manual_seed(seed)
        astate, vstate = tr.init(seed=0, generator=g)
        return tr, astate, vstate, g

    tr_k, ak, vk, gk = build(FusedPPOTrainer, 1)
    tr_x, ax, vx, gx = build(MXUPPOTrainer, 2)
    u = tr_k.draw_u(gk, T)
    psk.counts.reset()
    _, sk, _ = tr_k.collect(ak, vk, u, tr_k.vec.draw_mechanics(gk, T))
    assert psk.counts.plain_calls == 1
    _, sx, _ = tr_x.collect(ax, vx, gx, T)
    n_k, n_x = float(sk.episodes), float(sx.episodes)
    assert n_k > 100 and n_x > 100, (n_k, n_x)
    m_k = float(sk.return_sum) / n_k
    m_x = float(sx.return_sum) / n_x
    sigma = 150.0 / np.sqrt(min(n_k, n_x))
    assert abs(m_k - m_x) < 5 * sigma, (m_k, m_x, sigma)


def test_ppo_stoch_train_chunk_composes():
    """Fused collect (B10) + fused optimize (B6) on whisky: finite loss,
    sane episode accounting, a working eval (tests/test_ppo_stoch_collect_
    kernel.py:139-155)."""
    cenv, _ = _compiled("whisky")
    tr = FusedPPOTrainer(PPOAgent(cenv, net="table", epochs=2, n_minibatches=4),
                         VecEnv(cenv, 64))
    g = torch.Generator().manual_seed(1)
    astate, vstate = tr.init(seed=0, generator=g)
    psk.counts.reset()
    pk.counts.reset()
    for _ in range(2):
        astate, vstate, stats, loss = tr.train_chunk(astate, vstate, g, 32)
        assert bool(torch.isfinite(loss)), loss
    assert (psk.counts.plain_calls, pk.counts.plain_calls) == (2, 2)
    assert float(stats.episodes) >= 0 and int(astate.step) == 2 * 32 * 64
    _, es = tr.eval_chunk(astate, tr.vec.reset(g), 110, generator=g)
    assert np.isfinite(float(es.return_sum)) and float(es.episodes) > 0


ABSENT_CLI = ["absent", "ppo-mlp", "--compiled", "--mxu", "--table-net", "--fused-kernel",
              "--n-envs", "32", "--steps", "20000", "--chunk-steps", "16",
              "--eval-every", "20", "--eval-steps", "110", "--lr", "0.001",
              "--entropy-bonus", "0.05", "--platform", "cpu"]


def test_cli_fused_ppo_stochastic_env(tmp_path):
    """The reference's CLI test of the path (tests/test_cli.py:452-475):
    absent's coin resets through both kernels' plain versions on the CPU,
    sane episode accounting and a finite loss."""
    pck.counts.reset()
    psk.counts.reset()
    pk.counts.reset()
    run(ABSENT_CLI + ["--log-dir", str(tmp_path)])
    # 20000 // (16 · 32) = 39 chunks, each one collect (B10, never B5) and one
    # optimize call.
    assert (psk.counts.plain_calls, pk.counts.plain_calls, pck.counts.plain_calls) == (39, 39, 0)
    assert psk.counts.launches == pk.counts.launches == 0
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train = [r for r in rows if r["prefix"] == "train"]
    assert train and train[-1]["episodes"] > 0
    assert all(np.isfinite(r["loss"]) for r in train), train


def test_cli_mxu_ppo_runs_on_a_stochastic_alias(tmp_path):
    """The non-fused path (``MXUPPOTrainer``, per-step draws) on whisky's
    stumble: no collect kernel runs; 128 training steps per lane and a
    110-step eval both pass the 100-step timeout, so both finish episodes,
    and the loss is finite."""
    psk.counts.reset()
    pck.counts.reset()
    stats = run(["whisky", "ppo-mlp", "--compiled", "--mxu", "--n-envs", "32",
                 "--chunk-steps", "16", "--steps", "4096", "--chunks-per-dispatch", "8",
                 "--eval-steps", "110", "--platform", "cpu", "--log-dir", str(tmp_path)])
    assert psk.counts.plain_calls == pck.counts.plain_calls == 0
    assert stats["env_steps"] == 110 * 32 and stats["episodes"] > 0
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train = [r for r in rows if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [4096]
    assert train[0]["episodes"] > 0 and np.isfinite(train[0]["loss"]), train
