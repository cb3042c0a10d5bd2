"""DQN on sokoban: nets and their conversion, the TD loss, the replay ring and
n-step windows, kernels B3 (collect) and B4 (update) through their plain
versions, the fused trainer and the CLI.

Identical numpy inputs go through the JAX package and the port. The Pallas
kernels run in interpret mode on the CPU, as the JAX package's own tests run
them. Tolerances:

* B3 (collect), the ring and the n-step windows: bitwise — every value is an
  integer or a sum of integers, added in the reference's order.
* TD loss and its gradient: rtol 2e-5 on the loss, rtol 2e-4 (atol 1e-7 for
  elements that cancel to ~0) on the gradients — the matmuls sum in another
  order than XLA's.
* B4 (update) against the Pallas kernel: params, target, μ, ν at rtol 2e-4 /
  atol 1e-6, the loss at rtol 2e-5 — the reference's own tolerances
  (tests/test_dqn_update_kernel.py:71-89); the two differ in summation order
  and the Pallas kernel writes Adam's bias correction as 1 − exp(t·log β).
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from safe_grid_agents_tpu.agents.dqn import DQNAgent as JaxDQNAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import TableState as JaxTableState  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.ops.dqn_kernel import dqn_collect_run  # noqa: E402
from safe_grid_agents_tpu.training.dqn import push_traj_windows as jax_push_windows  # noqa: E402
from safe_grid_agents_tpu.training.dqn_pallas import PallasDQNTrainer  # noqa: E402
from safe_grid_agents_tpu.types import Experience  # noqa: E402
from safe_grid_agents_tpu.utils import replay as jax_replay  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.dqn import DQNAgent  # noqa: E402
from safe_grid_agents_torch.agents.networks import param_shapes  # noqa: E402
from safe_grid_agents_torch.cli.main import run  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.compiled import TableState  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.ops import dqn_kernel as dk  # noqa: E402
from safe_grid_agents_torch.ops import dqn_update_kernel as duk  # noqa: E402
from safe_grid_agents_torch.ops.rollout_kernel import Tables  # noqa: E402
from safe_grid_agents_torch.training import (  # noqa: E402
    FusedDQNTrainer, push_traj_windows, stats_to_host,
)
from safe_grid_agents_torch.utils import replay  # noqa: E402

torch.set_num_threads(1)
NETS = [(True, False), (False, False), (True, True)]  # (table, double_q)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _envs(alias="sokoban"):
    return make_env(alias, compiled=True, device="cpu"), jax_compile(jax_make_env(alias))


def _jax_batch(rng, reach, n):
    s = rng.choice(reach, n).astype(np.int32)
    nx = rng.choice(reach, n).astype(np.int32)
    return dict(
        s_idx=s, s_t=rng.integers(0, 100, n).astype(np.int32),
        action=rng.integers(0, 4, n).astype(np.int32),
        reward=rng.choice([-1.0, 49.0, -6.0, -11.0, 2.5], n).astype(np.float32),
        n_idx=nx, n_t=rng.integers(0, 100, n).astype(np.int32),
        done=rng.random(n) < 0.25,
    )


def _to_jax(b):
    return Experience(
        state=JaxTableState(idx=jnp.asarray(b["s_idx"]), t=jnp.asarray(b["s_t"])),
        action=jnp.asarray(b["action"]), reward=jnp.asarray(b["reward"]),
        next_state=JaxTableState(idx=jnp.asarray(b["n_idx"]), t=jnp.asarray(b["n_t"])),
        done=jnp.asarray(b["done"]),
    )


def _to_port(b):
    return replay.Transition(**{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})


# ---- (b) parameter conversion ----------------------------------------------

@pytest.mark.parametrize("table", [True, False])
def test_convert_qnet_params_round_trip(table):
    cenv, jc = _envs()
    jagent = JaxDQNAgent(jc, table=table, hidden=(64, 32))
    tree = _np_tree(jagent.init_params(jax.random.PRNGKey(3)))
    params = convert.qnet_params_from_flax(tree, table, "cpu")
    shapes = param_shapes(144, (64, 32), 4)
    assert {k: tuple(v.shape) for k, v in params.items()} == shapes
    back = convert.qnet_params_to_flax(params, table)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # Flat vectors (the JAX DQN trainers' flat Adam moments) follow flax's
    # leaf order: Dense_0/bias, Dense_0/kernel, ..., then b1, w1.
    flat, unravel = ravel_pytree(tree)
    np.testing.assert_array_equal(convert.qnet_params_to_flat(params, table), np.asarray(flat))
    order = convert.qnet_flat_order(shapes, table)
    assert order == (["b2", "w2", "b3", "w3", "b1", "w1"] if table
                     else ["b1", "w1", "b2", "w2", "b3", "w3"])
    moment = np.random.default_rng(0).normal(size=flat.shape).astype(np.float32)
    mu = convert.qnet_params_from_flat(moment, shapes, table, "cpu")
    by_tree = convert.qnet_params_from_flax(_np_tree(unravel(jnp.asarray(moment))), table, "cpu")
    for k in shapes:
        assert torch.equal(mu[k], by_tree[k]), k
    np.testing.assert_array_equal(convert.qnet_params_to_flat(mu, table), moment)


# ---- (c) TD loss and its gradient ------------------------------------------

@pytest.mark.parametrize("table,double_q", NETS)
def test_td_loss_and_grad_match_jax(table, double_q):
    cenv, jc = _envs()
    kw = dict(table=table, double_q=double_q, n_step=3, discount=0.97)
    agent, jagent = DQNAgent(cenv, **kw), JaxDQNAgent(jc, **kw)
    p = jagent.init_params(jax.random.PRNGKey(0))
    # A target net that differs from the online one.
    tp = jax.tree.map(lambda x: x + 0.05 * jnp.sin(jnp.arange(x.size).reshape(x.shape)), p)
    b = _jax_batch(np.random.default_rng(1), cenv.reachable.numpy(), 128)
    loss, grads = jax.value_and_grad(jagent.td_loss)(p, tp, _to_jax(b))

    leaves = {k: v.requires_grad_(True)
              for k, v in convert.qnet_params_from_flax(_np_tree(p), table, "cpu").items()}
    target = convert.qnet_params_from_flax(_np_tree(tp), table, "cpu")
    tloss = agent.td_loss(leaves, target, _to_port(b))
    tgrads = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=2e-5)
    jg = convert.qnet_params_from_flax(_np_tree(grads), table, "cpu")
    for k in jg:
        np.testing.assert_allclose(tgrads[k].numpy(), jg[k].numpy(), rtol=2e-4, atol=1e-7,
                                   err_msg=k)
    # Greedy actions and ε agree too (first max; float32 anneal).
    pp = convert.qnet_params_from_flax(_np_tree(p), table, "cpu")
    idx = cenv.reachable
    st = TableState(idx=idx, t=torch.zeros_like(idx))
    jst = JaxTableState(idx=jnp.asarray(idx.numpy()), t=jnp.zeros(len(idx), jnp.int32))
    jstate = jagent.init(jax.random.PRNGKey(0)).replace(params=p)
    np.testing.assert_array_equal(agent.act(SimpleNamespace(params=pp), st).numpy(),
                                  np.asarray(jagent.act(jstate, jst, None)))
    for step in (0, 1, 1_000, 299_999, 300_000, 2**31 - 1):
        got = agent.current_epsilon(torch.tensor(step)).numpy()
        want = np.asarray(jagent.current_epsilon(jnp.int32(step)))
        assert got.dtype == want.dtype and got == want, step


# ---- (d) the ring and n-step windows ----------------------------------------

def _jax_example():
    z = JaxTableState(idx=jnp.int32(0), t=jnp.int32(0))
    return Experience(state=z, action=jnp.int32(0), reward=jnp.float32(0.0),
                      next_state=z, done=jnp.bool_(False))


def _assert_ring_equal(buf, jbuf):
    st = jbuf.storage
    want = dict(s_idx=st.state.idx, s_t=st.state.t, action=st.action, reward=st.reward,
                n_idx=st.next_state.idx, n_t=st.next_state.t, done=st.done)
    for k, v in want.items():
        got = getattr(buf.storage, k).numpy()
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    assert buf.idx == int(jbuf.idx) and buf.size == int(jbuf.size)


def test_replay_ring_matches_jax_across_wraps():
    cap = 96
    rng = np.random.default_rng(2)
    reach = np.arange(60)
    buf = replay.init(cap, "cpu")
    jbuf = jax_replay.init(cap, _jax_example())
    # Partial pushes that wrap, a push of exactly the capacity (the roll), one
    # larger than the capacity (trimmed to its newest cap records).
    for n in (40, 50, 30, cap, 7, 2 * cap + 5, 11):
        b = _jax_batch(rng, reach, n)
        buf = replay.push_batch(buf, _to_port(b))
        jbuf = jax_replay.push_batch(jbuf, _to_jax(b))
        _assert_ring_equal(buf, jbuf)
    g = torch.Generator().manual_seed(0)
    sample = replay.sample(buf, g, 32)
    assert sample.action.shape == (32,)


@pytest.mark.parametrize("n_step", [1, 3])
def test_push_traj_windows_matches_jax(n_step):
    T, N, cap = 20, 16, 1000
    cenv, jc = _envs()
    agent = DQNAgent(cenv, n_step=n_step, discount=0.9, replay_capacity=cap)
    jagent = JaxDQNAgent(jc, n_step=n_step, discount=0.9, replay_capacity=cap)
    rng = np.random.default_rng(n_step)
    tr = dict(s_idx=rng.integers(0, 1296, (T, N)).astype(np.int32),
              s_t=rng.integers(0, 100, (T, N)).astype(np.int32),
              action=rng.integers(0, 4, (T, N)).astype(np.int32),
              reward=rng.choice([-1.0, 49.0, -6.0, -11.0], (T, N)).astype(np.float32),
              n_idx=rng.integers(0, 1296, (T, N)).astype(np.int32),
              n_t=rng.integers(0, 100, (T, N)).astype(np.int32),
              done=rng.random((T, N)) < 0.2)
    t = {k: torch.from_numpy(v) for k, v in tr.items()}
    buf = replay.init(cap, "cpu")
    for _ in range(2):
        buf = push_traj_windows(agent, buf, (
            TableState(t["s_idx"], t["s_t"]), t["action"], t["reward"],
            TableState(t["n_idx"], t["n_t"]), t["done"]))
    jbuf = jax_replay.init(cap, _jax_example())
    j = {k: jnp.asarray(v) for k, v in tr.items()}
    for _ in range(2):
        jbuf = jax_push_windows(jagent, jbuf, (
            JaxTableState(j["s_idx"], j["s_t"]), j["action"], j["reward"],
            JaxTableState(j["n_idx"], j["n_t"]), j["done"]))
    _assert_ring_equal(buf, jbuf)
    assert buf.size == 2 * (T - n_step + 1) * N
    if n_step == 1:  # bitwise the per-step push
        np.testing.assert_array_equal(buf.storage.reward[: T * N].numpy(),
                                      tr["reward"].reshape(-1))


# ---- (e) kernel B3: plain version vs the Pallas kernel ------------------------

def _lane_state(rng, reach, n, start, reset_idx):
    if start == "reset":
        return (np.full(n, reset_idx, np.int32), np.zeros(n, np.int32),
                np.zeros(n, np.float32), np.zeros(n, np.float32), np.zeros(n, np.int32))
    return (rng.choice(reach, n).astype(np.int32), rng.integers(0, 100, n).astype(np.int32),
            rng.integers(-30, 5, n).astype(np.float32), rng.integers(-30, 5, n).astype(np.float32),
            rng.integers(0, 60, n).astype(np.int32))


@pytest.mark.parametrize("alias,start,mode", [
    ("shift", "reset", "anneal"), ("shift", "mid", "anneal"),
    ("sokoban", "reset", "anneal"), ("sokoban", "mid", "anneal"),
    ("sokoban", "mid", "warmup"), ("sokoban", "reset", "cheat"),
])
def test_dqn_collect_plain_matches_pallas_kernel(alias, start, mode):
    N, T = 64, 32
    cenv, jc = _envs(alias)
    vec = VecEnv(cenv, N)
    cheat = mode == "cheat"
    jagent = JaxDQNAgent(jc, table=True, epsilon=0.6, epsilon_anneal_steps=5_000,
                         replay_capacity=4096)
    jtr = PallasDQNTrainer(jagent, MXUVecEnv(jc, N), cheat=cheat)
    rng = np.random.default_rng(hash((alias, start, mode)) % 2**32)
    S, A = vec.S, vec.A
    greedy = rng.integers(0, A, S).astype(np.int32)
    state = _lane_state(rng, cenv.reachable.numpy(), N, start, vec.reset_idx)
    rand_a = rng.integers(0, A, (T, N)).astype(np.int32)
    u = rng.random((T, N), dtype=np.float32)
    step0 = 3_000  # ε anneals across the chunk (0.6 → 0.05 by 5000)

    row = jnp.zeros((1, jtr.S_pad), jtr._dtype).at[0, :S].set(jnp.asarray(greedy).astype(jtr._dtype))
    static = jtr._static_warm if mode == "warmup" else jtr._static
    jouts = dqn_collect_run(static, jnp.concatenate([jtr._w_static, row], 0),
                            tuple(jnp.asarray(x).reshape(1, N) for x in state),
                            jnp.full((1, 1), step0, jnp.int32), jnp.asarray(rand_a),
                            jnp.asarray(u))

    hyper = dk.CollectHyper(0.6, 0.05, 5_000.0, cheat)
    if mode == "warmup":
        hyper = hyper.warmup()
    dk.counts.reset()
    outs = dk.dqn_collect(Tables.from_env(cenv, vec.reset_idx), hyper, torch.from_numpy(greedy),
                          convert.engine_state_from_numpy(state, "cpu"),
                          torch.tensor([step0]), torch.from_numpy(rand_a), torch.from_numpy(u))
    assert dk.counts.plain_calls == 1 and dk.counts.launches == 0
    names = ["idx", "t", "ep_return", "ep_hidden", "ep_len", "step", "episodes",
             "return_acc", "hidden_acc", "length_acc", "pre_idx", "pre_t", "action",
             "reward", "next_idx", "done"]
    assert len(outs) == len(jouts) == len(names)
    for name, a, b in zip(names, outs, jouts):
        if name == "step":
            assert int(a[0]) == int(np.asarray(b)[0, 0]) == step0 + T * N
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    acts = outs[12].numpy()
    if mode == "warmup":
        np.testing.assert_array_equal(acts, rand_a)
    else:  # both branches of ε-greedy were taken
        assert (acts != rand_a).any() and (acts != greedy[outs[10].numpy()]).any()


# ---- (f) kernel B4: plain version vs the Pallas kernel ------------------------

def _check_update_against_pallas(table, double_q, hidden, B, U):
    """U updates (sync_every=3) of the plain version against the Pallas
    kernel on the same warmed-up ring and batch indices."""
    cenv, jc = _envs()
    kw = dict(table=table, double_q=double_q, lr=1e-3, batch_size=B,
              replay_capacity=4096, sync_every=3, hidden=hidden)
    agent, jagent = DQNAgent(cenv, **kw), JaxDQNAgent(jc, **kw)
    jtr = PallasDQNTrainer(jagent, MXUVecEnv(jc, 64))
    assert jtr._fused_update
    astate, mstate = jtr.init(jax.random.PRNGKey(0))
    astate, mstate, _ = jtr.warmup_chunk(astate, mstate, jax.random.PRNGKey(1), 32)
    key = jax.random.PRNGKey(7)
    a2, jloss = jtr._update_scan(astate, key, U)

    idxs = np.asarray(jax.random.randint(key, (U, B), 0, astate.buffer.size))
    st = astate.buffer.storage
    batch = replay.Transition(**{k: torch.from_numpy(np.asarray(v)[idxs]) for k, v in dict(
        s_idx=st.state.idx, s_t=st.state.t, action=st.action, reward=st.reward,
        n_idx=st.next_state.idx, n_t=st.next_state.t, done=st.done).items()})
    shapes = param_shapes(144, hidden, 4)
    adam = astate.opt_state[0]
    duk.counts.reset()
    params, target, mu, nu, count, updates, loss = duk.dqn_update(
        agent,
        convert.qnet_params_from_flax(_np_tree(astate.params), table, "cpu"),
        convert.qnet_params_from_flax(_np_tree(astate.target_params), table, "cpu"),
        convert.qnet_params_from_flat(np.asarray(adam.mu), shapes, table, "cpu"),
        convert.qnet_params_from_flat(np.asarray(adam.nu), shapes, table, "cpu"),
        torch.tensor([int(adam.count)]), torch.tensor([int(astate.updates)]), batch)
    assert duk.counts.plain_calls == 1 and duk.counts.launches == 0

    tol = dict(rtol=2e-4, atol=1e-6)
    for label, got, want in (("params", params, a2.params), ("target", target, a2.target_params)):
        want = convert.qnet_params_from_flax(_np_tree(want), table, "cpu")
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol,
                                       err_msg=f"{label}.{k} (table={table}, double_q={double_q})")
    adam2 = a2.opt_state[0]
    np.testing.assert_allclose(convert.qnet_params_to_flat(mu, table), np.asarray(adam2.mu), **tol)
    np.testing.assert_allclose(convert.qnet_params_to_flat(nu, table), np.asarray(adam2.nu), **tol)
    np.testing.assert_allclose(float(loss[0]), float(jloss), rtol=2e-5)
    assert int(count[0]) == int(adam2.count) == int(adam.count) + U
    assert int(updates[0]) == int(a2.updates) == int(astate.updates) + U
    # The target really was synced inside the run (after update 3).
    assert not torch.equal(target["w2"], convert.qnet_params_from_flax(
        _np_tree(astate.target_params), table, "cpu")["w2"])


@pytest.mark.parametrize("table,double_q", NETS)
def test_dqn_update_plain_matches_pallas_kernel(table, double_q):
    # 8 updates with sync_every=3 → two sync boundaries inside the run.
    _check_update_against_pallas(table, double_q, (64, 64), 64, 8)


@pytest.mark.parametrize("table,double_q", [(False, False), (True, True)])
def test_dqn_update_plain_matches_pallas_kernel_on_a_grid_route_net(table, double_q):
    """A net no cluster holds (hidden 336, the grid route's shape on the
    card), 4 updates of 32 samples with a target sync inside."""
    assert duk.route(144, 336, 336, 4, 32) == "grid"
    _check_update_against_pallas(table, double_q, (336, 336), 32, 4)


# ---- (g) the fused trainer learns sokoban ---------------------------------------

def test_fused_dqn_trainer_learns_sokoban():
    """The geometry of test_dqn_kernel_learns_sokoban (tests/test_dqn_kernel.py):
    N=128, T=32, U=32, 15 chunks, best greedy eval from chunk 8."""
    cenv = make_env("sokoban", compiled=True, device="cpu")
    agent = DQNAgent(cenv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                     replay_capacity=50_000, sync_every=100)
    tr = FusedDQNTrainer(agent, VecEnv(cenv, 128), updates_per_chunk=32)
    astate, vstate = tr.init(seed=0)
    g = torch.Generator().manual_seed(2)
    dk.counts.reset()
    duk.counts.reset()
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 32)
    best = -1e9
    for i in range(15):
        astate, vstate, stats, loss = tr.train_chunk(astate, vstate, g, 32)
        assert bool(torch.isfinite(loss))
        if i >= 8:
            _, es = tr.eval_chunk(astate, tr.vec.reset(), 60)
            best = max(best, stats_to_host(es)["mean_return"])
    assert (dk.counts.plain_calls, duk.counts.plain_calls) == (16, 15)
    assert int(astate.step) == 16 * 32 * 128 and int(astate.updates) == 15 * 32
    assert best >= 40.0, f"fused DQN best eval {best}"


def test_fused_dqn_trainer_refusals():
    cenv = make_env("sokoban", compiled=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A.9"):
        FusedDQNTrainer(DQNAgent(cenv, hidden=(32, 32, 32)), VecEnv(cenv, 8))
    with pytest.raises(NotImplementedError, match="A.9"):
        DQNAgent(cenv, prioritized=True)
    tr = FusedDQNTrainer(DQNAgent(cenv, hidden=(16, 16)), VecEnv(cenv, 8))
    astate, vstate = tr.init()
    with pytest.raises(ValueError, match="multiples of 16"):
        tr.warmup_chunk(astate, vstate, torch.Generator(), 40)


# ---- (h) the CLI ------------------------------------------------------------------

DQN = ["sokoban", "deep-q", "--compiled", "--mxu", "--fused-kernel"]
CPU = ["--platform", "cpu"]


def test_cli_dqn_short_run_logs_loss(tmp_path):
    """Table net, double-Q, 3-step windows and K=2 chunks per logging step
    through the CLI: every collect and update runs the kernels' plain
    versions on the CPU, and the train rows carry a finite loss."""
    dk.counts.reset()
    duk.counts.reset()
    stats = run(DQN + [
        "--table-net", "--double-q", "--n-step", "3", "--cheat",
        "--n-envs", "64", "--steps", "40000", "--chunk-steps", "32",
        "--chunks-per-dispatch", "2", "--updates-per-chunk", "8",
        "--batch-size", "64", "--replay-capacity", "20000",
        "--warmup-steps", "32", "--eval-every", "4", "--eval-steps", "60",
        "--log-dir", str(tmp_path)] + CPU)
    # 40000 // (32 · 64 · 2) = 9 logging steps of 2 chunks, plus the warmup.
    assert (dk.counts.plain_calls, duk.counts.plain_calls) == (19, 18)
    assert dk.counts.launches == duk.counts.launches == 0
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train = [r for r in rows if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [4 * 4096, 8 * 4096, 9 * 4096]
    assert train[-1]["episodes"] > 0 and train[-1]["loss"] is not None
    assert rows[-1]["prefix"] == "eval" and stats["env_steps"] == 60 * 64


@pytest.mark.parametrize("argv, match", [
    (DQN + ["--preset"], "--warmup-steps 40 must be a multiple of 16"),
    (DQN + ["--chunk-steps", "40"], "--chunk-steps 40 must be a multiple of 16"),
    (DQN + ["--prioritized"], "A.9"),
    (DQN + ["--per-alpha", "0.5"], "A.9"),
    (DQN + ["--n-layers", "3"], "A.9"),
    (["sokoban", "deep-q", "--compiled", "--mxu"], "A.9"),
    (["sokoban", "deep-q"], "A.9"),
    (DQN + ["--n-devices", "2"], "A.14"),
    (DQN + ["--eval-env", "sokoban2"], "A.8"),
])
def test_cli_dqn_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + CPU)


def test_dqn_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cenv = make_env("sokoban", compiled=True, device="cpu")
    for call in (
        lambda: DQNAgent(cenv).init(),
        lambda: run(DQN + ["--warmup-steps", "32"]),
        lambda: convert.qnet_params_from_flat(np.zeros(4), {"b1": (4,)}, False),
    ):
        with pytest.raises(RuntimeError, match="--platform cpu"):
            call()
