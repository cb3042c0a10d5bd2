"""Prioritized replay: the port's PER ring and ``DQNAgent``'s PER update
against the JAX package's, on the same numpy inputs.

* The ring: the same pushes (a wrap, a push of exactly the capacity, a push
  wider than it) and priority writes give bitwise equal priorities, write
  index and fill level; on the slots ``jax.random.categorical`` draws, the
  importance weights agree within rtol 1e-6. Then the reference's own ring
  gates (``tests/test_agents.py:223``, ``:248``, ``:390``) on the port's
  sampler (``torch.multinomial``).
* The update: ``DQNAgent.update`` on a PER ring filled from one trajectory
  (n-step windows), from the reference's params and Adam state, on the
  slots the reference draws, matches ``DQNAgent.update`` of the JAX package:
  params, target and Adam moments rtol 2e-4 / atol 1e-6 (kernel B4's
  tolerances), the loss rtol 2e-5, the written-back priorities rtol 2e-4 /
  atol 1e-6; double-Q and 3-step windows, on the array engine and on the
  compiled env's table net.
* The base ``DQNTrainer`` takes PER with no change of its own: a short
  chunk pushes through the PER ring and writes priorities back.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.agents.dqn import DQNAgent as JaxDQNAgent  # noqa: E402
from safe_grid_agents_tpu.training.dqn import push_traj_windows as jax_push  # noqa: E402
from safe_grid_agents_tpu.utils import replay as jreplay  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.dqn import DQNAgent  # noqa: E402
from safe_grid_agents_torch.training import DQNTrainer, push_traj_windows  # noqa: E402
from safe_grid_agents_torch.utils import replay  # noqa: E402
from test_torch_array_engine import N, engines, reset_pair  # noqa: E402
from test_torch_array_learners import _jax_traj, _np_tree, _port_record  # noqa: E402

torch.set_num_threads(1)
DQN_TOL = dict(rtol=2e-4, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), err_msg=what,
                               **tol)


def _jax_slots(priorities, key, batch_size):
    """The slots ``replay.sample_prioritized`` of the JAX package draws."""
    logits = jnp.where(priorities > 0, 0.6 * jnp.log(jnp.maximum(priorities, 1e-12)),
                       -jnp.inf)
    return jax.random.categorical(key, logits, shape=(batch_size,))


# ---- the ring ----------------------------------------------------------------------

@pytest.mark.parametrize("eps, clip", [(0.05, 1.0), (0.0, 0.1)])
def test_per_ring_matches_jax(eps, clip):
    """Pushes of 10, 30 (a wrap), 64 (the whole ring) and 90 (wider than
    it), priority writes between them (repeated slots carry equal |δ|), and
    samples at two (α, β): priorities, idx and size equal, weights within
    rtol 1e-6 on the reference's slots."""
    cap = 64
    rng = np.random.default_rng(0)
    jbuf = jreplay.init_prioritized(cap, {"x": jnp.float32(0.0)})
    buf = replay.init_like(cap, {"x": torch.zeros(1)}, prioritized=True)
    key = jax.random.PRNGKey(1)
    for n in (10, 30, 64, 90):
        x = rng.normal(size=n).astype(np.float32)
        jbuf = jreplay.push_batch_prioritized(jbuf, {"x": jnp.asarray(x)}, eps=eps, clip=clip)
        buf = replay.push_batch_prioritized(buf, {"x": _t(x)}, eps=eps, clip=clip)
        np.testing.assert_array_equal(buf.storage["x"].numpy(), np.asarray(jbuf.storage["x"]))
        np.testing.assert_array_equal(buf.priorities.numpy(), np.asarray(jbuf.priorities))
        assert (buf.idx, buf.size) == (int(jbuf.idx), int(jbuf.size))
        slots = rng.integers(0, buf.size, 24)
        td = (np.sin(slots * 1.7) * 3.0).astype(np.float32)  # equal on repeated slots
        jbuf = jreplay.update_priorities(jbuf, jnp.asarray(slots), jnp.asarray(td), eps=eps,
                                         clip=clip)
        buf = replay.update_priorities(buf, _t(slots), _t(td), eps=eps, clip=clip)
        np.testing.assert_array_equal(buf.priorities.numpy(), np.asarray(jbuf.priorities))
        for alpha, beta in ((0.6, 0.4), (1.0, 0.85)):
            key, k = jax.random.split(key)
            _, jslots, jw = jreplay.sample_prioritized(jbuf, k, 32, alpha,
                                                       jnp.float32(beta))
            got, w = replay.sample_prioritized(buf, None, 32, alpha,
                                               torch.tensor(beta, dtype=torch.float32),
                                               slots=_t(jslots))
            np.testing.assert_array_equal(got.numpy(), np.asarray(jslots))
            _close(w, jw, f"weights n={n} alpha={alpha}", rtol=1e-6, atol=0.0)


def test_per_sampling_proportional_to_priority():
    """``tests/test_agents.py:223`` on the port's sampler: draw frequencies
    track p^α over the valid prefix, and β = 1 weights invert them."""
    buf = replay.init_like(8, {"x": torch.zeros(1)}, prioritized=True)
    buf = replay.push_batch_prioritized(buf, {"x": torch.arange(4, dtype=torch.float32)})
    buf = replay.update_priorities(buf, torch.arange(4), torch.tensor([1.0, 2.0, 3.0, 4.0]),
                                   eps=0.0, clip=100.0)
    idxs, weights = replay.sample_prioritized(buf, torch.Generator().manual_seed(0), 20_000,
                                              alpha=1.0, beta=torch.tensor(1.0))
    counts = np.bincount(idxs.numpy(), minlength=8)
    assert counts[4:].sum() == 0, "sampled an invalid slot"
    freqs = counts[:4] / counts[:4].sum()
    expect = np.array([1, 2, 3, 4]) / 10.0
    assert np.allclose(freqs, expect, atol=0.02), (freqs, expect)
    w_by_slot = np.zeros(4)
    w_by_slot[idxs.numpy()] = weights.numpy()
    assert np.argmax(w_by_slot) == 0 and np.argmin(w_by_slot[:4]) == 3
    assert abs(float(weights.mean()) - 1.0) < 1e-5  # unit-mean normalisation


def test_per_new_pushes_get_max_priority():
    """``tests/test_agents.py:248``: the entry floor ``(1 + eps)·clip``
    (1.05, and 0.105 at clip 0.1), the max for later pushes, and no zero
    priority at eps = 0."""
    buf = replay.init_like(8, {"x": torch.zeros(1)}, prioritized=True)
    buf = replay.push_batch_prioritized(buf, {"x": torch.zeros(2)})
    assert abs(float(buf.priorities[:2].min()) - 1.05) < 1e-6
    buf = replay.update_priorities(buf, torch.tensor([0]), torch.tensor([7.0]), eps=0.0,
                                   clip=100.0)
    buf = replay.push_batch_prioritized(buf, {"x": torch.zeros(2)})
    assert float(buf.priorities[2]) == 7.0, "new entry should get max priority"
    small = replay.init_like(8, {"x": torch.zeros(1)}, prioritized=True)
    small = replay.push_batch_prioritized(small, {"x": torch.zeros(2)}, clip=0.1)
    assert abs(float(small.priorities[0]) - 0.105) < 1e-6
    small = replay.update_priorities(small, torch.tensor([0]), torch.tensor([0.0]), eps=0.0,
                                     clip=0.1)
    assert float(small.priorities[0]) > 0.0


def test_per_push_wider_than_capacity_and_full_ring_replacement():
    """``tests/test_agents.py:390``'s PER half: a push of 6 into 4 slots
    keeps the newest 4 at the per-step positions, every slot at the floor;
    then a push of exactly the capacity sets every slot to the largest
    priority."""
    buf = replay.init_like(4, {"x": torch.zeros(1)}, prioritized=True)
    buf = replay.push_batch_prioritized(buf, {"x": torch.arange(6, dtype=torch.float32)})
    np.testing.assert_array_equal(buf.storage["x"].numpy(), [4, 5, 2, 3])
    assert (buf.priorities.numpy() == np.float32(1.05)).all()
    assert (buf.idx, buf.size) == (2, 4)
    buf = replay.update_priorities(buf, torch.tensor([1]), torch.tensor([0.2]))
    buf = replay.update_priorities(buf, torch.tensor([3]), torch.tensor([0.0]), eps=0.0)
    assert float(buf.priorities[3]) == float(np.float32(1e-6))  # floored, still sampleable
    buf = replay.push_batch_prioritized(buf, {"x": 10 + torch.arange(4, dtype=torch.float32)})
    np.testing.assert_array_equal(buf.storage["x"].numpy(), [12, 13, 10, 11])
    assert (buf.priorities.numpy() == np.float32(1.05)).all() and buf.idx == 2


# ---- the agent's update ------------------------------------------------------------

@pytest.mark.parametrize("compiled, double_q, n_step",
                         [(False, True, 3), (True, True, 3), (True, False, 1)])
def test_per_update_matches_jax(compiled, double_q, n_step):
    """PER rings filled from one trajectory (their entry priorities bitwise
    equal), then updates from the reference's params and Adam state on the
    slots the reference draws, a target sync among them."""
    vec, jvec = engines("sokoban", compiled)
    kw = dict(lr=1e-3, batch_size=32, replay_capacity=400, sync_every=3, double_q=double_q,
              n_step=n_step, hidden=(64, 32), table=compiled, prioritized=True,
              epsilon_anneal_steps=5000)
    agent, jagent = DQNAgent(vec.env, **kw), JaxDQNAgent(jvec.env, **kw)
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(1))
    acts = np.random.default_rng(3).integers(0, 4, (12, N)).astype(np.int32)
    jtraj = _jax_traj(jvec, jvs, acts)
    jastate = jagent.init(jax.random.PRNGKey(5))
    jastate = jastate.replace(buffer=jax_push(jagent, jastate.buffer, jtraj),
                              step=jnp.int32(1200))
    cls = type(vs.env)
    traj = (_port_record(cls, jtraj[0]), _t(jtraj[1]), _t(jtraj[2]),
            _port_record(cls, jtraj[3]), _t(jtraj[4]))
    buffer = push_traj_windows(agent, agent.init("cpu", states=vs.env).buffer, traj)
    np.testing.assert_array_equal(buffer.priorities.numpy(),
                                  np.asarray(jastate.buffer.priorities))
    assert buffer.size == int(jastate.buffer.size) and buffer.idx == int(jastate.buffer.idx)
    update = jax.jit(jagent.update)
    for u in range(2):   # move the reference off zero moments and uniform priorities
        jastate, _ = update(jastate, jax.random.PRNGKey(100 + u))
    adam = jastate.opt_state[0]
    buffer.priorities.copy_(_t(jastate.buffer.priorities))
    astate = convert.dqn_state_from_jax(
        _np_tree(jastate.params), _np_tree(jastate.target_params), adam.count,
        _np_tree(adam.mu), _np_tree(adam.nu), jastate.step, jastate.updates, buffer, compiled,
        "cpu")
    assert abs(float(agent.current_beta(astate.step))
               - float(jagent.current_beta(jastate.step))) == 0.0
    for u in range(4):
        key = jax.random.PRNGKey(200 + u)
        slots = _t(_jax_slots(jastate.buffer.priorities, key, 32))
        jastate, jloss = update(jastate, key)
        astate, loss = agent.update(astate, slots=slots)
        _close(loss, jloss, f"update {u} loss", rtol=2e-5, atol=0.0)
        _close(astate.buffer.priorities, jastate.buffer.priorities, f"update {u} priorities",
               **DQN_TOL)
    adam = jastate.opt_state[0]
    for got, want, what in ((astate.params, jastate.params, "params"),
                            (astate.target_params, jastate.target_params, "target"),
                            (astate.mu, adam.mu, "mu"), (astate.nu, adam.nu, "nu")):
        want = convert.qnet_params_from_flax(_np_tree(want), compiled, "cpu")
        for k in want:
            _close(got[k], want[k].numpy(), f"{what} {k}", **DQN_TOL)
    assert int(astate.count) == int(adam.count) and int(astate.updates) == int(jastate.updates)


def test_base_dqn_trainer_runs_prioritized_replay():
    """The base ``DQNTrainer`` takes PER through the agent alone: per-step
    pushes (n = 1) and the chunk's windows (n = 3) enter at the floor, and
    each update writes the sampled slots' |δ| back."""
    for n_step in (1, 3):
        vec, _ = engines("sokoban")
        agent = DQNAgent(vec.env, batch_size=16, replay_capacity=2048, hidden=(16,),
                         prioritized=True, n_step=n_step, per_clip=5.0)
        tr = DQNTrainer(agent, vec, updates_per_chunk=3)
        g = torch.Generator().manual_seed(0)
        astate, vs = tr.init(generator=g)
        astate, vs, _ = tr.warmup_chunk(astate, vs, g, 8)
        pri = astate.buffer.priorities
        assert astate.buffer.size == (8 - n_step + 1) * N
        assert (pri[:astate.buffer.size] == np.float32(1.05 * 5.0)).all()
        assert (pri[astate.buffer.size:] == 0).all()
        astate, vs, _, loss = tr.train_chunk(astate, vs, g, 8)
        assert torch.isfinite(loss)
        written = pri[:astate.buffer.size]
        assert bool((written < np.float32(1.05 * 5.0)).any()) and bool((written > 0).all())


def test_ring_conversion_round_trips_a_jax_per_ring():
    """``convert.ring_from_jax`` takes the JAX compact PER ring (storage,
    idx, size, priorities) as it is, and ``ring_to_numpy`` gives it back."""
    vec, jvec = engines("sokoban", True)
    jagent = JaxDQNAgent(jvec.env, replay_capacity=300, table=True, prioritized=True)
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(1))
    acts = np.random.default_rng(2).integers(0, 4, (10, N)).astype(np.int32)
    jbuf = jax_push(jagent, jagent.init(jax.random.PRNGKey(0)).buffer,
                    _jax_traj(jvec, jvs, acts))
    jbuf = jreplay.update_priorities(jbuf, jnp.arange(5), jnp.linspace(0.0, 2.0, 5))
    storage = jax.tree.map(np.asarray, {
        "state": {"idx": jbuf.storage.state.idx, "t": jbuf.storage.state.t},
        "next_state": {"idx": jbuf.storage.next_state.idx, "t": jbuf.storage.next_state.t},
        "action": jbuf.storage.action, "reward": jbuf.storage.reward,
        "done": jbuf.storage.done})
    buf = convert.ring_from_jax(storage, jbuf.idx, jbuf.size, jbuf.priorities, device="cpu")
    assert isinstance(buf.storage, replay.Transition) and buf.size == 240 and buf.idx == 240
    back, idx, size, pri = convert.ring_to_numpy(buf)
    np.testing.assert_array_equal(pri, np.asarray(jbuf.priorities))
    for k in ("action", "reward", "done"):
        np.testing.assert_array_equal(back[k], storage[k])
    for k in ("state", "next_state"):
        for f in ("idx", "t"):
            np.testing.assert_array_equal(back[k][f], storage[k][f])
    assert (idx, size) == (240, 240)
