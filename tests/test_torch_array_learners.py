"""The base trainers over the array engine, and the MXU tabular scan, against
the JAX package's on the same inputs.

Draws are handed over: the reference's explore key chain (``split`` into a
``randint`` and a ``bernoulli``, which is ``uniform < ε``), its lanes' key
chain (``tests/test_torch_array_engine.py``), its ``categorical`` as
Gumbel-max on the same uniforms, its replay slots and its permutations.
Tolerances:

* tabular and MXU tabular Q: atol 1e-4 (``tests/test_tabular_kernel.py:91``),
  step counts, lanes and episode statistics equal;
* the DQN update: params, target and Adam moments rtol 2e-4 / atol 1e-6, the
  loss rtol 2e-5 (kernel B4's tolerances); the replay rings bitwise;
* the PPO optimize: params rtol 2e-4 / atol 2e-6, μ rtol 2e-4 / atol 1e-6,
  the loss rtol 2e-5 / atol 1e-6, the Adam count equal (``net="pallas"``
  runs kernel B11's plain version here, the reference its Pallas kernel in
  interpret mode);
* CRMDP: the collected trajectory bitwise (actions, arrivals, rewards),
  the corruption table and the relabeled rewards atol 1e-6 (the port sums
  the attribution in fixed point, ``agents/crmdp.py``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.agents.crmdp import PPOCRMDPAgent as JaxCRMDPAgent  # noqa: E402
from safe_grid_agents_tpu.agents.dqn import DQNAgent as JaxDQNAgent  # noqa: E402
from safe_grid_agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent  # noqa: E402
from safe_grid_agents_tpu.agents.tabular import TabularQAgent as JaxTabularQAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.training.crmdp import CRMDPTrainer as JaxCRMDPTrainer  # noqa: E402
from safe_grid_agents_tpu.training.dqn import push_traj_windows as jax_push  # noqa: E402
from safe_grid_agents_tpu.training.ppo import PPOTrainer as JaxPPOTrainer  # noqa: E402
from safe_grid_agents_tpu.training.tabular import TabularQTrainer as JaxTabularTrainer  # noqa: E402
from safe_grid_agents_tpu.training.tabular_mxu import MXUTabularQTrainer as JaxMXUTrainer  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.crmdp import PPOCRMDPAgent  # noqa: E402
from safe_grid_agents_torch.agents.dqn import DQNAgent  # noqa: E402
from safe_grid_agents_torch.agents.ppo import PPOState  # noqa: E402
from safe_grid_agents_torch.agents.ppo import PPOAgent  # noqa: E402
from safe_grid_agents_torch.agents.tabular import TabularQAgent  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.training import (  # noqa: E402
    CRMDPTrainer, MXUTabularQTrainer, PPOTrainer, TabularQTrainer, push_traj_windows,
)
from safe_grid_agents_torch.utils import replay  # noqa: E402
from test_torch_array_engine import N, engines, port_draws, reset_pair  # noqa: E402

torch.set_num_threads(1)
Q_ATOL = 1e-4
DQN_TOL = dict(rtol=2e-4, atol=1e-6)
PPO_TOL = dict(params=dict(rtol=2e-4, atol=2e-6), mu=dict(rtol=2e-4, atol=1e-6),
               loss=dict(rtol=2e-5, atol=1e-6))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), err_msg=what, **tol)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@jax.jit
def _explore_step(k, like):
    """One step of the reference's ε-greedy key chain: ``(k', rand_a, u)``."""
    k, ka = jax.random.split(k)
    k1, k2 = jax.random.split(ka)
    return k, jax.random.randint(k1, like.shape, 0, 4), jax.random.uniform(k2, like.shape)


def explore_draws(key, n_steps, n):
    rand, u, like = [], [], jnp.zeros(n)
    for _ in range(n_steps):
        key, r, x = _explore_step(key, like)
        rand.append(np.asarray(r))
        u.append(np.asarray(x))
    return _t(np.stack(rand).astype(np.int32)), _t(np.stack(u))


def _port_record(cls, jrec):
    return cls(**{f: _t(getattr(jrec, f)) for f in jrec.__dataclass_fields__})


# ---- tabular Q ---------------------------------------------------------------------

@pytest.mark.parametrize("alias", ["shift", "friend"])
def test_tabular_trainer_chunk_matches_jax(alias):
    """One chunk of ``TabularQTrainer`` on the reference's explore draws and
    lanes' draws (friend: the carried coin reset), T = 120 steps across the
    100-step timeout, then a second chunk from the result."""
    vec, jvec = engines(alias)
    kw = dict(lr=0.2, epsilon_anneal_steps=3000, epsilon_final=0.05)
    agent, jagent = TabularQAgent(vec.env, **kw), JaxTabularQAgent(jvec.env, **kw)
    tr, jtr = TabularQTrainer(agent, vec), JaxTabularTrainer(jagent, jvec)
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(2))
    astate, jastate = agent.init("cpu"), jagent.init(jax.random.PRNGKey(0))
    chunk = jax.jit(jtr.train_chunk, static_argnums=3)
    steps = 0
    for c, T in enumerate((120, 40)):
        key = jax.random.PRNGKey(10 + c)
        draws = port_draws(vec, jvs, T)
        jastate, jvs, jstats = chunk(jastate, jvs, key, T)
        astate, vs, stats = tr.train_chunk(astate, vs, None, T, explore=explore_draws(key, T, N),
                                           env_draws=draws)
        steps += T * N
        _close(astate.q, jastate.q, f"chunk {c} Q", rtol=0.0, atol=Q_ATOL)
        assert int(astate.step) == int(jastate.step) == steps, c
        for f in jvs.env.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(vs.env, f).numpy(),
                                          np.asarray(getattr(jvs.env, f)), err_msg=f)
        for f in ("episodes", "return_sum", "hidden_sum", "length_sum", "env_steps"):
            assert float(getattr(stats, f)) == float(getattr(jstats, f)), (c, f)
    assert float(astate.q.abs().max()) > 0.0


@pytest.mark.parametrize("alias", ["shift"])
def test_mxu_tabular_trainer_chunk_matches_jax(alias):
    """One chunk of the MXU tabular scan over the compiled engine (the TD
    update a scatter here, one-hot matmuls in the reference)."""
    cenv = make_env(alias, compiled=True, device="cpu")
    jc = jax_make_env(alias, compiled=True)
    kw = dict(lr=0.2, epsilon_anneal_steps=2000, epsilon_final=0.05)
    agent, jagent = TabularQAgent(cenv, **kw), JaxTabularQAgent(jc, **kw)
    tr, jtr = MXUTabularQTrainer(agent, VecEnv(cenv, N)), JaxMXUTrainer(jagent, MXUVecEnv(jc, N))
    astate, vs = tr.init()
    jastate, jvs = jtr.init(jax.random.PRNGKey(0))
    np.testing.assert_array_equal(vs.idx.numpy(), np.asarray(jvs.idx))
    key, T = jax.random.PRNGKey(4), 120
    jastate, jvs, jstats = jax.jit(jtr.train_chunk, static_argnums=3)(jastate, jvs, key, T)
    astate, vs, stats = tr.train_chunk(astate, vs, None, T, explore=explore_draws(key, T, N))
    _close(astate.q, jastate.q, "Q", rtol=0.0, atol=Q_ATOL)
    assert int(astate.step) == int(jastate.step) == T * N
    np.testing.assert_array_equal(vs.idx.numpy(), np.asarray(jvs.idx))
    assert float(stats.episodes) == float(jstats.episodes) > 0


# ---- DQN ---------------------------------------------------------------------------

def _jax_traj(jvec, jvs, acts):
    """Step the JAX engine; return its chunk trajectory as the trainers
    record it (pre-step states, actions, rewards, pre-reset successors,
    dones), leaves ``[T, N, ...]``."""
    step = jax.jit(jvec.step)
    states, outs = [], []
    for a in acts:
        states.append(jvs.env)
        jvs, out = step(jvs, jnp.asarray(a))
        outs.append(out)
    stack = lambda *xs: jnp.stack(xs)  # noqa: E731
    return (jax.tree.map(stack, *states), jnp.asarray(acts),
            jnp.stack([o.reward for o in outs]),
            jax.tree.map(stack, *[o.pre_reset_env for o in outs]),
            jnp.stack([o.done for o in outs]))


@pytest.mark.parametrize("compiled, double_q, n_step", [(False, True, 3), (True, True, 3)])
def test_dqn_update_matches_jax(compiled, double_q, n_step):
    """Rings filled from one trajectory (n-step windows), then DQN updates
    from the reference's params and Adam state on the same sampled slots,
    a target sync among them; ``--compiled`` with the table-folded net."""
    vec, jvec = engines("sokoban", compiled)
    kw = dict(lr=1e-3, batch_size=32, replay_capacity=400, sync_every=3, double_q=double_q,
              n_step=n_step, hidden=(64, 32), table=compiled)
    agent, jagent = DQNAgent(vec.env, **kw), JaxDQNAgent(jvec.env, **kw)
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    acts = rng.integers(0, 4, (12, N)).astype(np.int32)
    jtraj = _jax_traj(jvec, jvs, acts)
    jastate = jagent.init(jax.random.PRNGKey(5))
    jastate = jastate.replace(buffer=jax_push(jagent, jastate.buffer, jtraj))
    cls = type(vs.env)
    traj = (_port_record(cls, jtraj[0]), _t(jtraj[1]), _t(jtraj[2]),
            _port_record(cls, jtraj[3]), _t(jtraj[4]))
    buffer = push_traj_windows(agent, agent.init("cpu", states=vs.env).buffer, traj)
    assert buffer.size == int(jastate.buffer.size) == (12 - n_step + 1) * N
    assert buffer.idx == int(jastate.buffer.idx)
    for name in ("state", "next_state"):
        for f in jtraj[0].__dataclass_fields__:
            np.testing.assert_array_equal(
                getattr(getattr(buffer.storage, name), f).numpy(),
                np.asarray(getattr(getattr(jastate.buffer.storage, name), f)), err_msg=f)
    for f in ("action", "reward", "done"):
        np.testing.assert_array_equal(getattr(buffer.storage, f).numpy(),
                                      np.asarray(getattr(jastate.buffer.storage, f)), err_msg=f)
    update = jax.jit(jagent.update)
    for u in range(2):   # move the reference off zero moments first
        jastate, _ = update(jastate, jax.random.PRNGKey(100 + u))
    adam = jastate.opt_state[0]
    astate = convert.dqn_state_from_jax(
        _np_tree(jastate.params), _np_tree(jastate.target_params), adam.count,
        _np_tree(adam.mu), _np_tree(adam.nu), jastate.step, jastate.updates, buffer, compiled,
        "cpu")
    for u in range(4):
        key = jax.random.PRNGKey(200 + u)
        slots = _t(jax.random.randint(key, (32,), 0, jnp.maximum(jastate.buffer.size, 1)))
        jastate, jloss = update(jastate, key)
        astate, loss = agent.update(astate, slots=slots)
        _close(loss, jloss, f"update {u} loss", rtol=2e-5, atol=0.0)
    adam = jastate.opt_state[0]
    for got, want, what in ((astate.params, jastate.params, "params"),
                            (astate.target_params, jastate.target_params, "target"),
                            (astate.mu, adam.mu, "mu"), (astate.nu, adam.nu, "nu")):
        want = convert.qnet_params_from_flax(_np_tree(want), compiled, "cpu")
        for k in want:
            _close(got[k], want[k].numpy(), f"{what} {k}", **DQN_TOL)
    assert int(astate.count) == int(adam.count) and int(astate.updates) == int(jastate.updates)


# ---- PPO ---------------------------------------------------------------------------

def _ppo_flat(jvec, jvs, rng, T):
    acts = rng.integers(0, 4, (T, N)).astype(np.int32)
    states = _jax_traj(jvec, jvs, acts)[0]
    B = T * N
    jstates = jax.tree.map(lambda x: x.reshape((B,) + x.shape[2:]), states)
    extra = dict(actions=acts.reshape(B),
                 old_logp=np.log(rng.uniform(0.1, 0.6, B)).astype(np.float32),
                 advantages=rng.normal(size=B).astype(np.float32),
                 returns=(10 * rng.normal(size=B)).astype(np.float32))
    return jstates, extra, B


def _perms(key, epochs, B):
    out = []
    for _ in range(epochs):
        key, kp = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(kp, B)))
    return torch.from_numpy(np.stack(out).astype(np.int64))


@pytest.mark.parametrize("net", ["mlp", "pallas"])
def test_ppo_optimize_matches_jax(net):
    """Two rounds of ``PPOTrainer.optimize`` (2 epochs × 4 minibatches each)
    on the same flat batch of shift states and the reference's permutations,
    from the reference's fresh params, then from the round's result."""
    vec, jvec = engines("shift")
    kw = dict(net=net, lr=1e-3, epochs=2, n_minibatches=4, entropy_bonus=0.05,
              hidden=(128, 128) if net == "pallas" else (64, 32))
    agent, jagent = PPOAgent(vec.env, **kw), JaxPPOAgent(jvec.env, **kw)
    tr, jtr = PPOTrainer(agent, vec), JaxPPOTrainer(jagent, jvec)
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(1))
    jstates, extra, B = _ppo_flat(jvec, jvs, np.random.default_rng(0), 6)
    jflat = {"states": jstates, **{k: jnp.asarray(v) for k, v in extra.items()}}
    flat = {"states": _port_record(type(vs.env), jstates),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}
    jastate = jagent.init(jax.random.PRNGKey(7))
    adam = jastate.opt_state[1][0]
    astate = convert.ppo_state_from_jax(
        _np_tree(jastate.params), adam.count, convert.ac_moments_to_flat(_np_tree(adam.mu)),
        convert.ac_moments_to_flat(_np_tree(adam.nu)), jastate.step, "cpu")
    optimize = jax.jit(jtr.optimize, static_argnums=3)
    coef = jnp.float32(0.05)
    for r in range(2):
        key = jax.random.PRNGKey(30 + r)
        params, opt_state, jloss = optimize(jastate, jflat, key, B, entropy_coef=coef)
        jastate = jastate.replace(params=params, opt_state=opt_state)
        p, mu, nu, count, loss = tr.optimize(astate, flat, _perms(key, 2, B), torch.tensor(0.05))
        astate = PPOState(params=p, mu=mu, nu=nu, count=count, step=astate.step)
        adam = jastate.opt_state[1][0]
        want = convert.ac_params_from_flax(_np_tree(params), "cpu")
        for k in want:
            _close(p[k], want[k].numpy(), f"round {r} {k}", **PPO_TOL["params"])
        _close(mu, convert.ac_moments_to_flat(_np_tree(adam.mu)), f"round {r} mu",
               **PPO_TOL["mu"])
        _close(loss, jloss, f"round {r} loss", **PPO_TOL["loss"])
        assert int(count) == int(adam.count) == 8 * (r + 1)


# ---- CRMDP -------------------------------------------------------------------------

@jax.jit
def _policy_u(k, like):
    """One step of the reference collect's key chain and the uniforms its
    ``categorical`` turns into Gumbel noise."""
    k, ka = jax.random.split(k)
    tiny = jnp.finfo(jnp.float32).tiny
    return k, jax.random.uniform(ka, like.shape, minval=tiny, maxval=1.0)


def test_crmdp_chunk_matches_jax():
    """One ``CRMDPTrainer`` chunk on corners: the collect on the reference's
    action draws reproduces its trajectory (arrivals from the pre-reset
    successors, across the 20-step timeout), then the corruption table and
    the relabeled rewards match; ``_learn`` keeps that table."""
    vec, jvec = engines("corners")
    kw = dict(lr=1e-3, entropy_bonus=0.05, crmdp_lr=1.0, hidden=(64, 32))
    agent, jagent = PPOCRMDPAgent(vec.env, **kw), JaxCRMDPAgent(jvec.env, **kw)
    tr, jtr = CRMDPTrainer(agent, vec), JaxCRMDPTrainer(jagent, jvec)
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(1))
    jastate = jagent.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(4)
    corruption = rng.normal(0.0, 0.5, jvec.env.num_states).astype(np.float32)
    jastate = jastate.replace(corruption=jnp.asarray(corruption))
    adam = jastate.opt_state[1][0]
    astate = convert.crmdp_state_from_jax(
        _np_tree(jastate.params), adam.count, convert.ac_moments_to_flat(_np_tree(adam.mu)),
        convert.ac_moments_to_flat(_np_tree(adam.nu)), jastate.step, corruption, "cpu")
    key, T = jax.random.PRNGKey(8), 48
    _, _, _, jtraj = jax.jit(jtr.collect, static_argnums=3)(jastate, jvs, key, T)
    u, k, like = [], key, jnp.zeros((N, 4))
    for _ in range(T):
        k, x = _policy_u(k, like)
        u.append(np.asarray(x))
    vs2, _, traj = tr.collect(astate, vs, None, T, policy_draws=_t(np.stack(u)))
    for name in ("actions", "next_idx", "rewards", "observed", "hidden", "dones"):
        np.testing.assert_array_equal(traj[name].numpy(), np.asarray(jtraj[name]),
                                      err_msg=name)
    assert bool(traj["dones"].any())
    for name in ("old_logp", "values"):
        _close(traj[name], jtraj[name], name, rtol=1e-5, atol=1e-5)
    jcorr = jagent.update_corruption(jastate.corruption, jtraj["next_idx"], jtraj["observed"],
                                     jtraj["hidden"])
    jrel = jagent.relabel(jcorr, jtraj["rewards"], jtraj["next_idx"])
    corr, rel = agent.attribute(astate.corruption, traj)
    _close(corr, jcorr, "corruption", rtol=0.0, atol=1e-6)
    _close(rel, jrel, "relabeled rewards", rtol=0.0, atol=1e-6)
    new, loss = tr._learn(astate, vs2, traj, torch.Generator().manual_seed(0), None)
    assert torch.equal(new.corruption, corr) and torch.isfinite(loss)
    assert int(new.step) == T * N and int(new.count) == agent.epochs * agent.n_minibatches


def test_dqn_experience_ring_bootstraps_from_the_pre_reset_successor():
    """The array engine's DQN pushes each transition's pre-reset successor:
    on boat every episode ends by the 100-step timeout, and the stored next
    state of that step is the timed-out state (t = 100), not the fresh lane
    (t = 0) that the engine carries on."""
    from safe_grid_agents_torch.training import DQNTrainer

    vec, _ = engines("boat")
    tr = DQNTrainer(DQNAgent(vec.env, replay_capacity=4096, hidden=(16,)), vec)
    astate, vs = tr.init(generator=torch.Generator().manual_seed(0))
    astate, vs, stats = tr.warmup_chunk(astate, vs, torch.Generator().manual_seed(1), 101)
    ring = replay.gather(astate.buffer, torch.arange(astate.buffer.size))
    assert astate.buffer.size == 101 * N and float(stats.episodes) == N
    done = ring.done
    assert int(done.sum()) == N and bool((ring.state.t[done] == 99).all())
    assert bool((ring.next_state.t[done] == 100).all())
    assert bool((vs.env.t == 1).all())   # the lanes restarted and took one step
