"""``MXUDQNTrainer`` and the fused DQN trainer's fallback, against the JAX
package's ``MXUDQNTrainer`` on the same numpy inputs.

* The update scan: from one filled ring (uniform or prioritized), the
  reference's params and flat Adam state, on the slots the reference's scan
  draws (each PER update's after the previous one's priority write), U
  updates of ``MXUDQNTrainer._update_scan`` match the reference's: params,
  target and Adam moments rtol 2e-4 / atol 1e-6, the mean loss rtol 2e-5,
  the priorities rtol 2e-4 / atol 1e-6, the counters equal.
* The collect: given the actions the reference's collect took (read back
  from its ring) and, on absent, the coin draws of its lanes' key chains,
  the port's collect pushes a ring bitwise equal to the reference's (with
  PER's entry priorities) and ends on the same lanes and step count.
* The fallback: ``FusedDQNTrainer`` with PER, or with three hidden layers,
  collects through B3 (B9 on absent) and then runs ``MXUDQNTrainer``'s
  scan: its chunk equals that collect followed by the scan of a plain
  ``MXUDQNTrainer``, bitwise, and B4 is not called.
* A short learning run: sokoban with PER and double-Q on the MXU trainer
  (``tests/test_agents.py:273``'s recipe) reaches ≥ 40.
"""
import dataclasses

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
from safe_grid_agents_tpu.training.dqn_mxu import MXUDQNTrainer as JaxMXUDQNTrainer  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.dqn import DQNAgent  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv, VecState  # noqa: E402
from safe_grid_agents_torch.ops import dqn_kernel as dk  # noqa: E402
from safe_grid_agents_torch.ops import dqn_stoch_kernel as dsk  # noqa: E402
from safe_grid_agents_torch.ops import dqn_update_kernel as duk  # noqa: E402
from safe_grid_agents_torch.training import (  # noqa: E402
    FusedDQNTrainer, MXUDQNTrainer, stats_to_host,
)
from safe_grid_agents_torch.types import map_leaves  # noqa: E402
from safe_grid_agents_torch.utils import replay  # noqa: E402

torch.set_num_threads(1)
DQN_TOL = dict(rtol=2e-4, atol=1e-6)
N = 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), err_msg=what,
                               **tol)


def _jring(buf):
    """The JAX compact ring's parts for ``convert.ring_from_jax``."""
    st = buf.storage
    storage = jax.tree.map(np.asarray, {
        "state": {"idx": st.state.idx, "t": st.state.t},
        "next_state": {"idx": st.next_state.idx, "t": st.next_state.t},
        "action": st.action, "reward": st.reward, "done": st.done})
    pri = getattr(buf, "priorities", None)
    return dict(storage=storage, idx=int(buf.idx), size=int(buf.size),
                priorities=None if pri is None else np.asarray(pri))


def _vec_state(m):
    return VecState(*(_t(getattr(m, f)) for f in ("idx", "t", "ep_return", "ep_hidden",
                                                   "ep_len")))


def _pair(alias, **kw):
    cenv = make_env(alias, compiled=True, device="cpu")
    jc = jax_make_env(alias, compiled=True)
    agent, jagent = DQNAgent(cenv, **kw), JaxDQNAgent(jc, **kw)
    return (MXUDQNTrainer(agent, VecEnv(cenv, N)),
            JaxMXUDQNTrainer(jagent, MXUVecEnv(jc, N)))


def _port_state(jtr, jastate, table, buffer):
    adam = jastate.opt_state[0]
    unravel = jtr._unravel
    return convert.dqn_state_from_jax(
        jax.tree.map(np.asarray, jastate.params),
        jax.tree.map(np.asarray, jastate.target_params), adam.count,
        jax.tree.map(np.asarray, unravel(adam.mu)), jax.tree.map(np.asarray, unravel(adam.nu)),
        jastate.step, jastate.updates, buffer, table, "cpu")


@pytest.mark.parametrize("prioritized", [False, True])
@pytest.mark.parametrize("table", [False, True])
def test_update_scan_matches_jax(prioritized, table):
    kw = dict(hidden=(32, 32), batch_size=32, replay_capacity=1024, sync_every=3,
              double_q=True, n_step=3, table=table, prioritized=prioritized,
              epsilon_anneal_steps=2000)
    tr, jtr = _pair("sokoban", **kw)
    jastate, mstate = jtr.init(jax.random.PRNGKey(0))
    jastate, mstate, _ = jax.jit(jtr.warmup_chunk, static_argnums=3)(
        jastate, mstate, jax.random.PRNGKey(2), 32)
    scan1 = jax.jit(jtr._update_scan, static_argnums=2)
    jastate, _ = scan1(jastate, jax.random.PRNGKey(3), 2)  # moments off zero
    jastate = jastate.replace(step=jnp.int32(900))
    astate = _port_state(jtr, jastate, table, _jring(jastate.buffer))
    if prioritized:
        np.testing.assert_array_equal(astate.buffer.priorities.numpy(),
                                      np.asarray(jastate.buffer.priorities))
    U, slots, jlosses = 5, [], []
    for u in range(U):
        key = jax.random.PRNGKey(40 + u)
        _, ku = jax.random.split(key)
        buf = jastate.buffer
        if prioritized:
            logits = jnp.where(buf.priorities > 0,
                               0.6 * jnp.log(jnp.maximum(buf.priorities, 1e-12)), -jnp.inf)
            slots.append(np.asarray(jax.random.categorical(ku, logits, shape=(32,))))
        else:
            slots.append(np.asarray(jax.random.randint(ku, (32,), 0,
                                                       jnp.maximum(buf.size, 1))))
        jastate, jloss = scan1(jastate, key, 1)
        jlosses.append(float(jloss))
    astate, loss = tr._update_scan(astate, None, U, slots=_t(np.stack(slots)))
    _close(loss, np.float32(np.mean(jlosses)), "mean loss", rtol=2e-5, atol=0.0)
    adam = jastate.opt_state[0]
    for got, want, what in ((astate.params, jastate.params, "params"),
                            (astate.target_params, jastate.target_params, "target"),
                            (astate.mu, jtr._unravel(adam.mu), "mu"),
                            (astate.nu, jtr._unravel(adam.nu), "nu")):
        want = convert.qnet_params_from_flax(jax.tree.map(np.asarray, want), table, "cpu")
        for k in want:
            _close(got[k], want[k].numpy(), f"{what} {k}", **DQN_TOL)
    if prioritized:
        _close(astate.buffer.priorities, jastate.buffer.priorities, "priorities", **DQN_TOL)
    assert int(astate.count) == int(adam.count) and int(astate.updates) == int(jastate.updates)


def _absent_bits(keys, T):
    """The coin each lane's key chain draws for each of T steps of the JAX
    MXU engine on absent (``split(k, 3)``: the step, reset and next keys)."""
    bits = []
    for _ in range(T):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        bits.append(np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, 0.5))(ks[:, 1])))
        keys = ks[:, 2]
    return np.stack(bits).astype(np.int32)


@pytest.mark.parametrize("alias, prioritized", [("sokoban", False), ("sokoban", True),
                                                ("absent", True)])
def test_collect_matches_jax(alias, prioritized):
    """T = 60 steps cross sokoban's timeout; a ring of twice the chunk."""
    T = 60
    kw = dict(hidden=(32, 32), replay_capacity=2 * T * N, epsilon_anneal_steps=2000,
              prioritized=prioritized)
    tr, jtr = _pair(alias, **kw)
    jastate, mstate = jtr.init(jax.random.PRNGKey(0))
    vs = _vec_state(mstate)
    draws = None
    if alias == "absent":
        zeros = torch.zeros((T, N), dtype=torch.int32)
        draws = (_t(_absent_bits(mstate.key, T)), zeros, zeros)
    jastate, mstate, _, jstats = jax.jit(jtr._collect, static_argnums=(3, 4))(
        jastate, mstate, jax.random.PRNGKey(3), T, False)
    acts = _t(np.asarray(jastate.buffer.storage.action[:T * N]).reshape(T, N))
    astate = tr.agent.init("cpu", 0)
    astate, vs, stats = tr._collect(astate, vs, None, T, False, actions=acts, env_draws=draws)
    want = _jring(jastate.buffer)
    got = convert.ring_to_numpy(astate.buffer)
    for k in ("action", "reward", "done"):
        np.testing.assert_array_equal(got[0][k], want["storage"][k], err_msg=k)
    for k in ("state", "next_state"):
        for f in ("idx", "t"):
            np.testing.assert_array_equal(got[0][k][f], want["storage"][k][f], err_msg=k + f)
    assert (got[1], got[2]) == (want["idx"], want["size"]) == (0 + T * N, T * N)
    if prioritized:
        np.testing.assert_array_equal(got[3], want["priorities"])
    assert int(astate.step) == int(jastate.step) == T * N
    np.testing.assert_array_equal(vs.idx.numpy(), np.asarray(mstate.idx))
    np.testing.assert_array_equal(vs.t.numpy(), np.asarray(mstate.t))
    for f in ("episodes", "return_sum", "hidden_sum", "length_sum"):
        assert float(getattr(stats, f)) == float(getattr(jstats, f)), f
    assert float(stats.episodes) > 0


@pytest.mark.parametrize("alias, kw", [
    ("sokoban", dict(prioritized=True, double_q=True)),
    ("sokoban", dict(hidden=(32, 32, 32))),
    ("absent", dict(prioritized=True, n_step=3)),
])
def test_fused_fallback_is_the_collect_kernel_then_the_scan(alias, kw):
    """The fused trainer's chunk where B4 does not take the net: B3 (B9)
    collects, then ``MXUDQNTrainer``'s scan, bitwise that of a plain
    ``MXUDQNTrainer`` run after the same collect from the same generator."""
    cenv = make_env(alias, compiled=True, device="cpu")
    agent = DQNAgent(cenv, **dict(dict(hidden=(16, 16), batch_size=32, replay_capacity=4096,
                                       sync_every=5), **kw))
    fused = FusedDQNTrainer(agent, VecEnv(cenv, N), updates_per_chunk=6)
    assert not fused.fused_update
    scan = MXUDQNTrainer(agent, fused.vec, updates_per_chunk=6)
    g = torch.Generator().manual_seed(0)
    astate, vstate = fused.init(seed=0, generator=g)
    astate, vstate, _ = fused.warmup_chunk(astate, vstate, g, 32)
    collect = dsk.counts if fused.stochastic else dk.counts
    collect.reset()
    duk.counts.reset()
    g_a, g_b = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    # Pushes and priority writes go to the ring in place: path b gets a copy.
    buf = astate.buffer
    copy = dataclasses.replace(astate, buffer=replay.BufferState(
        storage=map_leaves(torch.clone, buf.storage), idx=buf.idx, size=buf.size,
        priorities=None if buf.priorities is None else buf.priorities.clone()))
    a, va, sa, la = fused.train_chunk(astate, vstate, g_a, 32)
    b, vb, sb = fused._collect(copy, vstate, g_b, 32, random_policy=False)
    b, lb = scan._update_scan(b, g_b, 6)
    assert collect.plain_calls == 2 and duk.counts.plain_calls == 0
    assert collect.launches == duk.counts.launches == 0
    assert torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(va, vb))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]) and torch.equal(a.mu[k], b.mu[k]), k
    if agent.prioritized:
        assert torch.equal(a.buffer.priorities, b.buffer.priorities)
    assert int(a.updates) == int(astate.updates) + 6 and float(sa.env_steps) == 32 * N


def test_mxu_dqn_prioritized_learns_sokoban():
    """``tests/test_agents.py:273``'s recipe (PER + double-Q, N = 128, 15
    chunks of 32 steps, 32 updates of 128) on the MXU trainer."""
    cenv = make_env("sokoban", compiled=True, device="cpu")
    agent = DQNAgent(cenv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                     replay_capacity=50_000, sync_every=100, double_q=True, prioritized=True)
    tr = MXUDQNTrainer(agent, VecEnv(cenv, 128), updates_per_chunk=32)
    g = torch.Generator().manual_seed(0)
    astate, vstate = tr.init(seed=0, generator=g)
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 40)
    best = -1e9
    for i in range(15):
        astate, vstate, _, loss = tr.train_chunk(astate, vstate, g, 32)
        assert torch.isfinite(loss)
        if i >= 8:
            _, es = tr.eval_chunk(astate, tr.vec.reset(), 60)
            best = max(best, stats_to_host(es)["mean_return"])
    assert best >= 40.0, f"PER MXU DQN best eval {best}"


def test_new_entry_points_raise_without_a_card(monkeypatch):
    """PER, the MXU DQN trainer, ppo-cnn and the gates' tool target the card
    unless asked for the CPU, and raise instead of falling back."""
    from safe_grid_agents_torch.agents.ppo import PPOCNNAgent
    from safe_grid_agents_torch.cli.main import run
    from safe_grid_agents_torch.tools import agent_gates

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cenv = make_env("sokoban", compiled=True, device="cpu")
    for call in (
        lambda: DQNAgent(cenv, prioritized=True).init(),
        lambda: MXUDQNTrainer(DQNAgent(make_env("sokoban", compiled=True)), None),
        lambda: PPOCNNAgent(make_env("corners")).init(),
        lambda: run(["sokoban", "deep-q", "--compiled", "--mxu", "--prioritized"]),
        lambda: run(["shift", "ppo-cnn"]),
        lambda: agent_gates.main(["--only", "MXUDQNTrainer uniform"]),
    ):
        with pytest.raises(RuntimeError, match="--platform cpu"):
            call()


def test_agent_gates_tool_runs_a_fallback_job_on_the_cpu():
    """``tools/agent_gates.py`` (``chip_smoke.py`` phase 7's runs): the fused
    trainer at hidden 128 × 3 reaches its gate, calls B3's plain version
    16 times (15 chunks and the warmup) and B4's never."""
    from safe_grid_agents_torch.tools import agent_gates

    (r,), _ = agent_gates.run_jobs(["FusedDQNTrainer hidden 128x3"], "cpu")
    agent_gates.check_launches(r)
    assert r["passed"] and r["outcome"]["best"] >= 40.0, r["outcome"]
    assert r["plain_calls"]["dqn_collect"] == 16 and r["plain_calls"]["dqn_update"] == 0
    assert r["env_steps"] == 128 * (48 + 15 * 32) and r["wall_s"] > 0.0
    # Every kernel's counts are reported, and a launch of one the job must
    # not make fails its check.
    assert set(r["plain_calls"]) == set(agent_gates.all_counts())
    assert not any(v for k, v in r["plain_calls"].items() if k != "dqn_collect")
    stray = dict(r, plain_calls=dict(r["plain_calls"], ppo_collect=1))
    with pytest.raises(AssertionError, match="ppo_collect"):
        agent_gates.check_launches(stray)
