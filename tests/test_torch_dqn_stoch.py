"""Stochastic fused DQN collect kernel B9, the fused DQN trainer's stochastic
branch and its CLI path.

The port's plain B9 is held against the JAX Pallas kernel
``dqn_stoch_collect_run`` (interpret mode on the CPU, as its own tests run
it) on the same lanes, step counter, greedy row and five streams, the JAX
payload built by the JAX trainer's own ``_payload`` from params carried
across by ``convert``: every output must be equal (each is an integer, a
gather, or a sum in the reference's order). Then the numpy host replay of
``tests/test_dqn_kernel.py:161-258`` through ``FusedDQNTrainer._collect``
(ring contents and episode count), and the reference's learning gate on
whisky (``tests/test_dqn_kernel.py:261-285``).
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

from safe_grid_agents_tpu.agents.dqn import DQNAgent as JaxDQNAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.ops.dqn_stoch_kernel import dqn_stoch_collect_run  # noqa: E402
from safe_grid_agents_tpu.training.dqn_pallas import PallasDQNTrainer  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.dqn import DQNAgent  # noqa: E402
from safe_grid_agents_torch.cli.main import run  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.ops import dqn_kernel as dk  # noqa: E402
from safe_grid_agents_torch.ops import dqn_stoch_kernel as dsk  # noqa: E402
from safe_grid_agents_torch.ops import dqn_update_kernel as duk  # noqa: E402
from safe_grid_agents_torch.training import FusedDQNTrainer, stats_to_host  # noqa: E402

torch.set_num_threads(1)
HYPER = dict(table=True, epsilon=0.6, epsilon_anneal_steps=5_000, replay_capacity=4096)
NAMES = ["idx", "t", "ep_return", "ep_hidden", "ep_len", "step", "episodes",
         "return_acc", "hidden_acc", "length_acc", "pre_idx", "pre_t", "action",
         "reward", "next_idx", "done"]


@functools.lru_cache(maxsize=None)
def _compiled(alias):
    kw = {"cap": 15} if alias in ("friend", "foe", "neutral") else {}
    return (make_env(alias, compiled=True, device="cpu", **kw),
            jax_make_env(alias, compiled=True, **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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


ALIASES = ["absent", "interrupt", "whisky", "tomato", "neutral", "foe"]


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize("start", ["reset", "mid"])
def test_dqn_stoch_collect_plain_matches_pallas_kernel(alias, start):
    N, T = 32, 32
    cenv, jc = _compiled(alias)
    vec = VecEnv(cenv, N)
    jagent = JaxDQNAgent(jc, **HYPER)
    jtr = PallasDQNTrainer(jagent, MXUVecEnv(jc, N))
    assert jtr._stochastic and vec.stochastic
    tr = FusedDQNTrainer(DQNAgent(cenv, **HYPER), vec)
    # The greedy row of the JAX trainer's payload and the port's greedy row
    # of the same params, carried across.
    params = jagent.init_params(jax.random.PRNGKey(len(alias)))
    payload = jtr._payload(params)
    jgreedy = np.asarray(payload[-1, :vec.S]).astype(np.int32)
    greedy = tr.greedy_row(convert.qnet_params_from_flax(_np_tree(params), True, "cpu"))
    np.testing.assert_array_equal(greedy.numpy(), jgreedy)
    rng = np.random.default_rng(abs(hash((alias, start))) % 2**32)
    lanes = _lanes(rng, vec, N, start)
    streams = _streams(rng, vec, T, N)
    step0 = 3_000  # ε anneals across the chunk (0.6 → 0.05 by 5000)

    jouts = dqn_stoch_collect_run(jtr._static, payload,
                                  tuple(jnp.asarray(x).reshape(1, N) for x in lanes),
                                  jnp.full((1, 1), step0, jnp.int32),
                                  *(jnp.asarray(s) for s in streams))
    dsk.counts.reset()
    outs = dsk.dqn_stoch_collect(tr.tables, tr.hyper, greedy,
                                 convert.engine_state_from_numpy(lanes, "cpu"),
                                 torch.tensor([step0]), *(torch.from_numpy(s) for s in streams))
    assert dsk.counts.plain_calls == 1 and dsk.counts.launches == 0
    assert len(outs) == len(jouts) == len(NAMES)
    for name, a, b in zip(NAMES, outs, jouts):
        if name == "step":
            assert int(a[0]) == int(np.asarray(b)[0, 0]) == step0 + T * N
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=f"{alias} {start} {name}")
    acts = outs[12].numpy()  # both branches of ε-greedy were taken
    assert (acts != streams[0]).any() and (acts != jgreedy[outs[10].numpy()]).any()
    if start == "mid":
        assert float(outs[6].sum()) > 0  # episodes ended inside the chunk


@pytest.mark.parametrize("alias,mode", [(a, "anneal") for a in ALIASES]
                         + [("whisky", "warmup"), ("tomato", "cheat")])
def test_dqn_stoch_collect_matches_host_replay(alias, mode):
    """``FusedDQNTrainer._collect`` against the numpy replay of the five-
    stream protocol (tests/test_dqn_kernel.py:161-258): greedy off the frozen
    Q table at the PRE-dry index, whisky's noise on the EFFECTIVE action, the
    CHOSEN action and the pre-dry index in the ring, coin and carried
    resets, the env stepped at the DRIED index; warmup pins ε to 1 and
    ``--cheat`` stores the hidden reward."""
    cenv, _ = _compiled(alias)
    N, T = 64, 128  # past the 100-step timeout: every lane resets at least once
    agent = DQNAgent(cenv, **{**HYPER, "replay_capacity": T * N})
    tr = FusedDQNTrainer(agent, VecEnv(cenv, N), cheat=mode == "cheat")
    g = torch.Generator().manual_seed(9)
    astate, vstate = tr.init(generator=g)
    # The trainer's draws, replayed from a copy of the generator.
    g2 = torch.Generator()
    g2.set_state(g.get_state())
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g2).numpy()
    u = torch.rand((T, N), generator=g2).numpy()
    bits, stumble, rand2 = (x.numpy() for x in tr.vec.draw_mechanics(g2, T))
    q_all = agent.q_values(astate.params, tr._all_states).detach().numpy()
    astate2, vstate2, stats = tr._collect(astate, vstate, g, T, random_policy=mode == "warmup")

    tab = tr.vec.tables
    nxt_t = tab.next.numpy()
    rew_t = (tab.hidden if mode == "cheat" else tab.reward).numpy()
    done_t = tab.done.numpy().astype(bool)
    drunk = None if tab.drunk is None else tab.drunk.numpy().astype(bool)
    carry = tr.vec.carry_tab.numpy() if tab.mode == 2 else None
    idx = vstate[0][0].numpy().astype(np.int64)
    t = np.zeros(N, np.int64)
    store = astate2.buffer.storage
    step, episodes = 0, 0.0
    for s in range(T):
        frac = min(max(step / agent.epsilon_anneal_steps, 0.0), 1.0)
        eps = 1.0 if mode == "warmup" else (
            agent.epsilon + frac * (agent.epsilon_final - agent.epsilon))
        a = np.where(u[s] < eps, rand_a[s], q_all[idx].argmax(-1))      # chosen, pre-dry
        env_idx = idx - (idx & (2 ** tab.dry_nbits - 1) & bits[s]) if tab.dry_nbits else idx
        eff = a if drunk is None else np.where(drunk[env_idx] & (stumble[s] > 0), rand2[s], a)
        nx, r = nxt_t[env_idx, eff], rew_t[env_idx, eff]
        done = done_t[env_idx, eff] | (t + 1 >= tab.max_steps)
        sl = slice(s * N, (s + 1) * N)
        for name, want in (("s_idx", idx), ("action", a), ("reward", r), ("n_idx", nx),
                           ("done", done), ("s_t", t), ("n_t", t + 1)):
            np.testing.assert_array_equal(getattr(store, name)[sl].numpy(), want,
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
        step += N
    np.testing.assert_array_equal(vstate2[0][0].numpy(), idx)
    assert float(stats.episodes) == episodes and episodes > 0
    assert astate2.buffer.size == T * N and int(astate2.step) == T * N


def test_fused_dqn_trainer_learns_whisky():
    """The reference's outcome gate (tests/test_dqn_kernel.py:261-285): the
    quick config on whisky (N = 128, 15 chunks of 32, U = 32) reaches a best
    greedy eval ≥ 25 from chunk 8 (it drinks: ≈36; random ≈ −60)."""
    cenv, _ = _compiled("whisky")
    agent = DQNAgent(cenv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                     replay_capacity=50_000, sync_every=100)
    tr = FusedDQNTrainer(agent, VecEnv(cenv, 128), updates_per_chunk=32)
    g = torch.Generator().manual_seed(1)
    astate, vstate = tr.init(seed=0, generator=g)
    dsk.counts.reset()
    duk.counts.reset()
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 32)
    best = -1e9
    for i in range(15):
        astate, vstate, _, loss = tr.train_chunk(astate, vstate, g, 32)
        assert bool(torch.isfinite(loss))
        if i >= 8:
            _, es = tr.eval_chunk(astate, tr.vec.reset(g), 60, generator=g)
            best = max(best, stats_to_host(es)["mean_return"])
    assert (dsk.counts.plain_calls, duk.counts.plain_calls) == (16, 15)
    assert dsk.counts.launches == duk.counts.launches == 0
    assert best >= 25.0, f"fused stochastic DQN whisky best eval {best}"


def test_fused_dqn_trainer_refuses_ragged_chunks():
    cenv, _ = _compiled("absent")
    tr = FusedDQNTrainer(DQNAgent(cenv, hidden=(16, 16)), VecEnv(cenv, 8))
    g = torch.Generator().manual_seed(0)
    astate, vstate = tr.init(generator=g)
    with pytest.raises(ValueError, match="multiples of 16"):
        tr.warmup_chunk(astate, vstate, g, 40)
    with pytest.raises(ValueError, match="multiple of 16"):
        dsk.dqn_stoch_collect(tr.tables, tr.hyper, tr.greedy_row(astate.params), vstate,
                              astate.step.reshape(1), *(torch.zeros((24, 8), dtype=d) for d in (
                                  torch.int32, torch.float32, torch.int32, torch.int32,
                                  torch.int32)))


WHISKY_CLI = ["whisky", "deep-q", "--compiled", "--mxu", "--fused-kernel", "--n-envs", "64",
              "--steps", "12288", "--chunk-steps", "32", "--warmup-steps", "32",
              "--batch-size", "64", "--updates-per-chunk", "8", "--eval-every", "3",
              "--eval-steps", "40", "--platform", "cpu"]


def test_cli_whisky_deep_q_runs_on_b9(tmp_path):
    """``whisky deep-q --compiled --mxu --fused-kernel`` end to end: every
    collect runs B9's plain version on the CPU (never B3), every update B4's,
    and the train rows carry episodes and a finite loss."""
    dk.counts.reset()
    dsk.counts.reset()
    duk.counts.reset()
    stats = run(WHISKY_CLI + ["--log-dir", str(tmp_path)])
    # 12288 // (32 · 64) = 6 chunks, plus the warmup.
    assert (dsk.counts.plain_calls, duk.counts.plain_calls, dk.counts.plain_calls) == (7, 6, 0)
    assert dsk.counts.launches == duk.counts.launches == 0
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train = [r for r in rows if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [3 * 2048, 6 * 2048]
    assert all(r["episodes"] > 0 and np.isfinite(r["loss"]) for r in train), train
    assert rows[-1]["prefix"] == "eval" and stats["env_steps"] == 40 * 64
