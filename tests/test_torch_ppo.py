"""PPO on island: nets and their conversion, GAE and whitening, kernels B5
(collect), B6 (optimize) and B11 (fused forward) through their plain
versions, the MXU and fused trainers, and the CLI.

Identical numpy inputs go through the JAX package and the port. The Pallas
kernels run in interpret mode on the CPU, as the JAX package's own tests
run them. Tolerances:

* nets' forward: atol 1e-5 (tests/test_ops.py:33);
* GAE and whitening: atol 1e-6;
* B5 (collect): bitwise — every recorded value is a gather of a policy row
  or a table entry;
* B6 (optimize) and the fast optimize: params to rtol 2e-4 / atol 2e-6, μ
  to rtol 2e-4 / atol 1e-6, the loss to rtol 2e-5 / atol 1e-6, the Adam
  count exactly — the reference's own (tests/test_ppo_kernel.py:61-75);
  the two sides sum in other orders (autograd vs XLA autodiff vs the
  Pallas kernel's hand-derived backward);
* B11: forward atol 1e-5, gradients atol/rtol 1e-3 (tests/test_ops.py).
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from safe_grid_agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import TableState as JaxTableState  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.ops.fused_mlp import PallasActorCriticMLP as JaxPallasMLP  # noqa: E402
from safe_grid_agents_tpu.ops.ppo_collect_kernel import ppo_collect_run  # noqa: E402
from safe_grid_agents_tpu.training.ppo import _whiten as jax_whiten  # noqa: E402
from safe_grid_agents_tpu.training.ppo import compute_gae as jax_gae  # noqa: E402
from safe_grid_agents_tpu.training.ppo_mxu import MXUPPOTrainer as JaxMXUPPOTrainer  # noqa: E402
from safe_grid_agents_tpu.training.ppo_pallas import PallasPPOTrainer  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.ppo import PPOAgent, PPOState, ravel  # noqa: E402
from safe_grid_agents_torch.cli.main import run  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.compiled import TableState  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv, VecState  # noqa: E402
from safe_grid_agents_torch.ops import fused_mlp as fm  # noqa: E402
from safe_grid_agents_torch.ops import ppo_collect_kernel as pck  # noqa: E402
from safe_grid_agents_torch.ops import ppo_kernel as pk  # noqa: E402
from safe_grid_agents_torch.ops.rollout_kernel import Tables  # noqa: E402
from safe_grid_agents_torch.training import (  # noqa: E402
    FusedPPOTrainer, MXUPPOTrainer, compute_gae, stats_to_host, whiten,
)
from safe_grid_agents_torch.training.ppo_mxu import tile_geometry  # noqa: E402

torch.set_num_threads(1)
OPT_TOL = dict(params=dict(rtol=2e-4, atol=2e-6), mu=dict(rtol=2e-4, atol=1e-6),
               loss=dict(rtol=2e-5, atol=1e-6))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _envs():
    return make_env("island", compiled=True, device="cpu"), jax_compile(jax_make_env("island"))


def _assert_params_close(got, want_tree, tol, msg):
    want = convert.ac_params_from_flax(_np_tree(want_tree), "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol, err_msg=f"{msg} {k}")


def _perms(key, epochs, n_tiles):
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key, e), n_tiles))
                     for e in range(epochs)])


def _flat_batch(rng, reach, B, A):
    return dict(idx=rng.choice(reach, B).astype(np.int32),
                actions=rng.integers(0, A, B).astype(np.int32),
                old_logp=np.log(rng.uniform(0.1, 0.6, B)).astype(np.float32),
                advantages=rng.normal(size=B).astype(np.float32),
                returns=(10 * rng.normal(size=B)).astype(np.float32))


def _jax_flat(b):
    n = len(b["idx"])
    return {"states": JaxTableState(idx=jnp.asarray(b["idx"]), t=jnp.zeros(n, jnp.int32)),
            **{k: jnp.asarray(b[k]) for k in ("actions", "old_logp", "advantages", "returns")}}


def _port_flat(b):
    idx = torch.from_numpy(b["idx"])
    return {"states": TableState(idx=idx, t=torch.zeros_like(idx)),
            **{k: torch.from_numpy(b[k]) for k in ("actions", "old_logp", "advantages",
                                                   "returns")}}


# ---- (b) the nets, their conversion and the entropy anneal ------------------------

@pytest.mark.parametrize("net", ["table", "mlp", "pallas"])
def test_actor_critic_forward_matches_flax(net):
    cenv, jc = _envs()
    hidden = (128, 128) if net == "pallas" else (64, 32)
    agent = PPOAgent(cenv, net=net, hidden=hidden)
    jagent = JaxPPOAgent(jc, net=net, hidden=hidden)
    tree = _np_tree(jagent.init(jax.random.PRNGKey(3)).params)
    params = convert.ac_params_from_flax(tree, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == agent.shapes
    back = convert.ac_params_to_flax(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # The flat vector is ravel_pytree's: the Adam moments cross as they are.
    np.testing.assert_array_equal(ravel(params).numpy(), np.asarray(ravel_pytree(tree)[0]))

    idx = cenv.reachable
    logits, value = agent.policy_value(params, TableState(idx=idx, t=torch.zeros_like(idx)))
    jl, jv = jagent.policy_value(tree, JaxTableState(idx=jnp.asarray(idx.numpy()),
                                                     t=jnp.zeros(len(idx), jnp.int32)))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jv), atol=1e-5)
    # The port's own init has flax's shapes and scale.
    own = agent.init("cpu", seed=1)
    assert {k: tuple(v.shape) for k, v in own.params.items()} == agent.shapes
    assert own.step.dtype == own.count.dtype == torch.int64
    for k, v in own.params.items():
        ref = tree["params"]
        for part in k.split("."):
            ref = ref[part]
        assert abs(float(v.std(unbiased=False)) - float(np.std(ref))) <= 0.2 * float(np.std(ref)) + 1e-7, k


def test_entropy_anneal_and_greedy_act_match_jax():
    cenv, jc = _envs()
    kw = dict(net="table", entropy_bonus=0.5, entropy_final=0.0, entropy_anneal_steps=3_000_000)
    agent, jagent = PPOAgent(cenv, **kw), JaxPPOAgent(jc, **kw)
    for step in (0, 1, 65_536, 1_234_567, 2_999_999, 3_000_000, 5_000_000, 2**31 - 1):
        got = agent.entropy_coef(torch.tensor(step)).numpy()
        want = np.asarray(jagent.entropy_coef(jnp.int32(step)))
        assert got.dtype == want.dtype and got == want, step
    assert float(PPOAgent(cenv, entropy_bonus=0.01).entropy_coef(torch.tensor(5))) == \
        np.float32(0.01)
    jstate = jagent.init(jax.random.PRNGKey(0))
    params = convert.ac_params_from_flax(_np_tree(jstate.params), "cpu")
    idx = cenv.reachable
    got = agent.act_idx(PPOState(params, None, None, None, None), idx)
    want = jagent.act(jstate, JaxTableState(idx=jnp.asarray(idx.numpy()),
                                            t=jnp.zeros(len(idx), jnp.int32)), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- (c) GAE and whitening -----------------------------------------------------------

def test_gae_and_whiten_match_jax():
    T, N = 32, 128
    rng = np.random.default_rng(0)
    rew = rng.choice([-1.0, 49.0, -51.0, 0.5], (T, N)).astype(np.float32)
    val = (20 * rng.normal(size=(T, N))).astype(np.float32)
    done = rng.random((T, N)) < 0.1
    last = (20 * rng.normal(size=N)).astype(np.float32)
    adv, ret = compute_gae(*(torch.from_numpy(x) for x in (rew, val, done, last)), 0.99, 0.95)
    jadv, jret = jax_gae(*(jnp.asarray(x) for x in (rew, val, done, last)), 0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-6 * 50, rtol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), atol=1e-6 * 50, rtol=1e-6)
    w, jw = whiten(torch.from_numpy(np.array(jadv))), jax_whiten(jadv)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    assert abs(float(w.mean())) < 1e-5 and abs(float(w.std(unbiased=False)) - 1) < 1e-5


# ---- (d) kernel B5: plain version vs the Pallas kernel ---------------------------------

def _payload_rows(jtr, payload, S, A):
    """The policy rows inside the reference's collect payload."""
    w = np.asarray(payload)
    lp0 = A * 5
    return pck.PolicyRows(
        logp=torch.from_numpy(np.ascontiguousarray(w[lp0:lp0 + A, :S].T)),
        cdf=torch.from_numpy(np.ascontiguousarray(w[lp0 + A:lp0 + 2 * A - 1, :S].T)),
        value=torch.from_numpy(np.array(w[lp0 + 2 * A - 1, :S])))


@pytest.mark.parametrize("start", ["reset", "mid"])
def test_ppo_collect_plain_matches_pallas_kernel(start):
    N, T = 64, 32
    cenv, jc = _envs()
    vec = VecEnv(cenv, N)
    jagent = JaxPPOAgent(jc, net="table")
    jtr = PallasPPOTrainer(jagent, MXUVecEnv(jc, N))
    params = jagent.init(jax.random.PRNGKey(1)).params
    payload = jtr._collect_payload(params)
    rng = np.random.default_rng(4 if start == "reset" else 5)
    if start == "reset":
        state = (np.full(N, vec.reset_idx, np.int32), np.zeros(N, np.int32),
                 np.zeros(N, np.float32), np.zeros(N, np.float32), np.zeros(N, np.int32))
    else:
        reach = cenv.reachable.numpy()
        state = (rng.choice(reach, N).astype(np.int32), rng.integers(0, 100, N).astype(np.int32),
                 rng.integers(-30, 5, N).astype(np.float32),
                 rng.integers(-80, 5, N).astype(np.float32), rng.integers(0, 60, N).astype(np.int32))
    u = rng.random((T, N), dtype=np.float32)
    jouts = ppo_collect_run(jtr._cstatic, payload,
                            tuple(jnp.asarray(x).reshape(1, N) for x in state), jnp.asarray(u))
    rows = _payload_rows(jtr, payload, vec.S, vec.A)
    pck.counts.reset()
    outs = pck.ppo_collect(Tables.from_env(cenv, vec.reset_idx), rows,
                           convert.engine_state_from_numpy(state, "cpu"), torch.from_numpy(u))
    assert pck.counts.plain_calls == 1 and pck.counts.launches == 0
    names = ["idx", "t", "ep_return", "ep_hidden", "ep_len", "episodes", "return_acc",
             "hidden_acc", "length_acc", "pre_idx", "pre_t", "action", "logp", "value",
             "reward", "hidden", "done", "next_idx"]
    assert len(outs) == len(jouts) == len(names) == 18
    for name, a, b in zip(names, outs, jouts):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    acts = outs[11].numpy()
    assert len(np.unique(acts)) == vec.A and outs[5].numpy().sum() > 0
    assert (outs[14].numpy() != outs[15].numpy()).any()  # drownings: hidden ≠ observed


# ---- (e) kernel B6 and (f) the fast optimize against the reference ----------------------

def _optimize_case(n_envs, chunk, cls, hidden=(128, 128)):
    cenv, jc = _envs()
    kw = dict(net="table", epochs=2, n_minibatches=4, entropy_anneal_steps=5_000,
              hidden=hidden)
    agent, jagent = PPOAgent(cenv, **kw), JaxPPOAgent(jc, **kw)
    jtr = cls(jagent, MXUVecEnv(jc, n_envs))
    jstate, _ = jtr.init(jax.random.PRNGKey(0))
    B = n_envs * chunk
    flat = _flat_batch(np.random.default_rng(n_envs), cenv.reachable.numpy(), B, cenv.n_actions)
    return cenv, agent, jtr, jstate, flat, B


def _check_opt(got, jparams, jopt, jloss, count0, n_upd, label):
    params, mu, nu, count, loss = got
    _assert_params_close(params, jparams, OPT_TOL["params"], label)
    adam = jopt[1][0]
    np.testing.assert_allclose(mu.numpy(), np.asarray(adam.mu), **OPT_TOL["mu"])
    np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu), rtol=2e-4, atol=1e-9)
    np.testing.assert_allclose(float(loss), float(jloss), **OPT_TOL["loss"])
    assert int(count) == int(adam.count) == count0 + n_upd


@pytest.mark.parametrize("n_envs,chunk", [(64, 32), (128, 32)])
def test_ppo_optimize_plain_matches_pallas_kernel(n_envs, chunk):
    """B6's plain version on the stacked streams the JAX fused trainer
    builds from its fold_in(key, e) tile permutations, against
    ``ppo_optimize_run``, twice: from a fresh optimizer, then from the
    first call's result (converted from the reference)."""
    cenv, agent, jtr, jstate, flat, B = _optimize_case(n_envs, chunk, PallasPPOTrainer)
    ptr = FusedPPOTrainer(agent, VecEnv(cenv, n_envs))
    _, n_tiles, _ = tile_geometry(B, 4)
    for rnd in range(2):
        key = jax.random.PRNGKey(11 + rnd)
        ce = jnp.float32(0.3 - 0.1 * rnd)
        jparams, jopt, jloss = jtr.optimize_fast(jstate, _jax_flat(flat), key, B,
                                                 entropy_coef=ce)
        adam = jstate.opt_state[1][0]
        astate = convert.ppo_state_from_jax(_np_tree(jstate.params), int(adam.count),
                                            np.asarray(adam.mu), np.asarray(adam.nu), 0, "cpu")
        tree, count, mu, nu, step = convert.ppo_state_to_numpy(astate)
        assert (count, step) == (int(adam.count), 0)
        np.testing.assert_array_equal(mu, np.asarray(adam.mu))
        np.testing.assert_array_equal(nu, np.asarray(adam.nu))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(_np_tree(jstate.params))):
            np.testing.assert_array_equal(a, b)
        pk.counts.reset()
        got = ptr.optimize_fast(astate, _port_flat(flat),
                                torch.from_numpy(_perms(key, 2, n_tiles)), B,
                                torch.tensor(float(ce)))
        assert pk.counts.plain_calls == 1 and pk.counts.launches == 0
        _check_opt(got, jparams, jopt, jloss, int(adam.count), 8, f"round {rnd}")
        jstate = jstate.replace(params=jparams, opt_state=jopt)
    # The JAX kernel's tensor layout converts both ways.
    d_pad, S = jtr.D_pad, cenv.num_states
    tensors = jtr._to_tensors(jparams)
    port = convert.ppo_params_from_kernel_tensors([np.asarray(t) for t in tensors],
                                                  jtr.D, cenv.n_actions, "cpu")
    _assert_params_close(port, jparams, dict(rtol=0, atol=0), "layout")
    for a, b in zip(convert.ppo_kernel_tensors_from_params(port, d_pad), tensors):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert S == 72 and d_pad == 384


@pytest.mark.parametrize("hidden", [(160, 144), (136, 200)])
def test_ppo_optimize_plain_matches_pallas_kernel_at_a_wide_route_width(hidden):
    """B6's plain version at hidden widths above 128 (the wide route's
    shapes on the card), one fused optimize of 8 updates of 256 rows from a
    fresh optimizer, against ``ppo_optimize_run``."""
    cenv, agent, jtr, jstate, flat, B = _optimize_case(64, 16, PallasPPOTrainer, hidden)
    assert pk.route(72, 288, *hidden, 4) == "wide"
    ptr = FusedPPOTrainer(agent, VecEnv(cenv, 64))
    _, n_tiles, _ = tile_geometry(B, 4)
    key = jax.random.PRNGKey(13)
    ce = jnp.float32(0.2)
    jparams, jopt, jloss = jtr.optimize_fast(jstate, _jax_flat(flat), key, B, entropy_coef=ce)
    adam = jstate.opt_state[1][0]
    astate = convert.ppo_state_from_jax(_np_tree(jstate.params), int(adam.count),
                                        np.asarray(adam.mu), np.asarray(adam.nu), 0, "cpu")
    pk.counts.reset()
    got = ptr.optimize_fast(astate, _port_flat(flat), torch.from_numpy(_perms(key, 2, n_tiles)),
                            B, torch.tensor(float(ce)))
    assert pk.counts.plain_calls == 1 and pk.counts.launches == 0
    _check_opt(got, jparams, jopt, jloss, int(adam.count), 8, f"hidden {hidden}")


@pytest.mark.parametrize("net", ["table", "mlp"])
def test_mxu_optimize_fast_matches_jax(net):
    """The port's MXUPPOTrainer.optimize_fast (autograd, flat clip + Adam)
    against the JAX fast optimize on the same flat batch and permutations."""
    cenv, jc = _envs()
    kw = dict(net=net, epochs=2, n_minibatches=4, hidden=(64, 64), lr=1e-3)
    agent, jagent = PPOAgent(cenv, **kw), JaxPPOAgent(jc, **kw)
    n_envs, chunk = 64, 16
    jtr = JaxMXUPPOTrainer(jagent, MXUVecEnv(jc, n_envs))
    jstate, _ = jtr.init(jax.random.PRNGKey(2))
    B = n_envs * chunk
    flat = _flat_batch(np.random.default_rng(7), cenv.reachable.numpy(), B, cenv.n_actions)
    ptr = MXUPPOTrainer(agent, VecEnv(cenv, n_envs))
    _, n_tiles, _ = tile_geometry(B, 4)
    key = jax.random.PRNGKey(5)
    jparams, jopt, jloss = jtr.optimize_fast(jstate, _jax_flat(flat), key, B,
                                             entropy_coef=jnp.float32(0.05))
    adam = jstate.opt_state[1][0]
    astate = convert.ppo_state_from_jax(_np_tree(jstate.params), int(adam.count),
                                        np.asarray(adam.mu), np.asarray(adam.nu), 0, "cpu")
    got = ptr.optimize_fast(astate, _port_flat(flat), torch.from_numpy(_perms(key, 2, n_tiles)),
                            B, torch.tensor(0.05))
    _check_opt(got, jparams, jopt, jloss, 0, 8, net)


# ---- (g) kernel B11: the fused forward and its gradients ---------------------------------

def test_fused_mlp_forward_and_grads_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 4, 7, 9)).astype(np.float32)   # D = 252 → Dp = 256, odd B
    jnet = JaxPallasMLP(n_actions=4)
    tree = _np_tree(jnet.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    net = fm.PallasActorCriticMLP(252, 4)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in tree["params"].items()}
    fm.counts.reset()
    logits, value = net.apply(params, torch.from_numpy(x))
    assert fm.counts.plain_calls == 1 and fm.counts.launches == 0
    jl, jv = jnet.apply(tree, jnp.asarray(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jv), atol=1e-5)

    def jloss(p):
        lg, v = jnet.apply(p, jnp.asarray(x))
        return (lg ** 2).sum() + (v ** 2).sum()

    grads = _np_tree(jax.grad(jloss)(tree))["params"]
    loss = (logits ** 2).sum() + (value ** 2).sum()
    got = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), grads[k], atol=1e-3, rtol=1e-3, err_msg=k)
    # One observation (no batch dimension) as the flax module takes it.
    l1, v1 = net.apply(params, torch.from_numpy(x[0]))
    assert l1.shape == (4,) and v1.shape == ()


def test_mxu_trainer_with_fused_mlp_net_trains():
    """PPOAgent(net='pallas') on the MXU trainer: every forward goes
    through B11 (its plain version on the CPU), the loss stays finite."""
    cenv = make_env("island", compiled=True, device="cpu")
    agent = PPOAgent(cenv, net="pallas", entropy_bonus=0.5)
    tr = MXUPPOTrainer(agent, VecEnv(cenv, 32))
    astate, vstate = tr.init(seed=0)
    g = torch.Generator().manual_seed(0)
    fm.counts.reset()
    astate, vstate, stats, loss = tr.train_chunk(astate, vstate, g, 16)
    # 16 collect steps + the bootstrap value + 4 × 4 minibatch forwards.
    assert fm.counts.plain_calls == 16 + 1 + 16 and fm.counts.launches == 0
    assert bool(torch.isfinite(loss)) and float(stats.episodes) > 0
    assert int(astate.step) == 16 * 32 and int(astate.count) == 16


# ---- (h) the slice as a whole ------------------------------------------------------------

def test_fused_trainer_chunks_match_pallas_trainer():
    """Three train_chunks of both fused trainers from the same params, with
    the port handed the reference's draws (u from split(key)[0], the tile
    permutations from fold_in(ko, e))."""
    N, T = 64, 32
    cenv, jc = _envs()
    kw = dict(net="table", epochs=2, n_minibatches=4, entropy_bonus=0.5, entropy_final=0.0,
              entropy_anneal_steps=5_000)
    agent, jagent = PPOAgent(cenv, **kw), JaxPPOAgent(jc, **kw)
    jtr = PallasPPOTrainer(jagent, MXUVecEnv(jc, N))
    ptr = FusedPPOTrainer(agent, VecEnv(cenv, N))
    jstate, mstate = jtr.init(jax.random.PRNGKey(0))
    adam = jstate.opt_state[1][0]
    astate = convert.ppo_state_from_jax(_np_tree(jstate.params), int(adam.count),
                                        np.asarray(adam.mu), np.asarray(adam.nu), 0, "cpu")
    vstate = ptr.vec.reset()
    _, n_tiles, _ = tile_geometry(N * T, 4)
    key = jax.random.PRNGKey(7)
    pck.counts.reset()
    pk.counts.reset()
    for chunk in range(3):
        key, k = jax.random.split(key)
        k_u, k_out = jax.random.split(k)
        u = np.array(jax.random.uniform(k_u, (T, N), jnp.float32))
        perms = _perms(jax.random.split(k_out)[1], 2, n_tiles)
        # The policy rows of one set of params agree to atol 1e-6.
        jrows = _payload_rows(jtr, jtr._collect_payload(jstate.params), ptr.S, ptr.A)
        rows = ptr.policy_rows(convert.ac_params_from_flax(_np_tree(jstate.params), "cpu"))
        for f in ("logp", "cdf", "value"):
            np.testing.assert_allclose(getattr(rows, f).numpy(), getattr(jrows, f).numpy(),
                                       atol=1e-6, err_msg=f"chunk {chunk} {f}")
        # No draw lies within 1e-5 of a threshold of either side's own rows,
        # so the trajectories must be bitwise equal.
        _, _, _, jtraj = jtr.collect(jstate, mstate, k, T)
        own = ptr.policy_rows(astate.params)
        for cdf in (jrows.cdf, own.cdf):
            cdf_at = cdf.numpy()[np.asarray(jtraj["states"].idx)]      # [T, N, A-1]
            assert np.abs(u[:, :, None] - cdf_at).min() > 1e-5, chunk
        _, _, traj = ptr.collect(astate, vstate, torch.from_numpy(u))
        for name, a, b in (("idx", traj["states"].idx, jtraj["states"].idx),
                           ("t", traj["states"].t, jtraj["states"].t),
                           ("action", traj["actions"], jtraj["actions"]),
                           ("reward", traj["rewards"], jtraj["rewards"]),
                           ("done", traj["dones"], jtraj["dones"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{chunk} {name}")
        np.testing.assert_allclose(traj["old_logp"].numpy(), np.asarray(jtraj["old_logp"]),
                                   **OPT_TOL["params"])

        jstate, mstate, jstats, jloss = jtr.train_chunk(jstate, mstate, k, T)
        astate, vstate, stats, loss = ptr.train_chunk(astate, vstate, None, T,
                                                      u=torch.from_numpy(u),
                                                      perms=torch.from_numpy(perms))
        for f in ("idx", "t", "ep_return", "ep_hidden", "ep_len"):
            np.testing.assert_array_equal(getattr(vstate, f).numpy(),
                                          np.asarray(getattr(mstate, f)), err_msg=f)
        for f in ("episodes", "return_sum", "hidden_sum", "length_sum", "env_steps"):
            assert float(getattr(stats, f)) == float(getattr(jstats, f)), f
        got = (astate.params, astate.mu, astate.nu, astate.count, loss)
        _check_opt(got, jstate.params, jstate.opt_state, jloss, 8 * chunk, 8, f"chunk {chunk}")
        assert int(astate.step) == int(jstate.step) == (chunk + 1) * N * T
    assert (pck.counts.plain_calls, pk.counts.plain_calls) == (6, 3)
    assert pck.counts.launches == pk.counts.launches == 0


def test_fused_trainer_learns_island():
    """The island preset's recipe (lr 5e-4, entropy 0.5 annealed to 0) cut
    to N = 256, T = 32 and 40 chunks (328 k env steps, the anneal ending at
    200 k): one of the last two greedy evals must reach ≥ 40 (optimum 45;
    drowning gives −1 … −3)."""
    cenv = make_env("island", compiled=True, device="cpu")
    agent = PPOAgent(cenv, net="table", lr=5e-4, entropy_bonus=0.5, entropy_final=0.0,
                     entropy_anneal_steps=200_000)
    tr = FusedPPOTrainer(agent, VecEnv(cenv, 256))
    astate, vstate = tr.init(seed=0)
    g = torch.Generator().manual_seed(0)
    evals = []
    for i in range(40):
        astate, vstate, _, loss = tr.train_chunk(astate, vstate, g, 32)
        assert bool(torch.isfinite(loss))
        if i in (29, 39):
            _, es = tr.eval_chunk(astate, tr.vec.reset(), 30)
            evals.append(stats_to_host(es))
    assert max(e["mean_return"] for e in evals) >= 40.0, evals


def test_fused_trainer_refusals():
    cenv = make_env("island", compiled=True, device="cpu")
    vec = VecEnv(cenv, 8)
    with pytest.raises(ValueError, match="table-net"):
        FusedPPOTrainer(PPOAgent(cenv, net="mlp"), vec)
    with pytest.raises(ValueError, match="two hidden"):
        FusedPPOTrainer(PPOAgent(cenv, net="table", hidden=(32, 32, 32)), vec)
    with pytest.raises(ValueError, match="table-net"):
        FusedPPOTrainer(PPOAgent(cenv, net="cnn"), vec)
    tr = FusedPPOTrainer(PPOAgent(cenv, net="table", hidden=(16, 16)), vec)
    astate, vstate = tr.init()
    with pytest.raises(ValueError, match="multiple of 16"):
        tr.collect(astate, vstate, torch.rand(24, 8))


# ---- (i) the CLI ------------------------------------------------------------------------

PPO = ["island", "ppo-mlp", "--compiled", "--mxu", "--table-net", "--fused-kernel"]
CPU = ["--platform", "cpu"]


def test_cli_fused_ppo_short_run(tmp_path):
    pck.counts.reset()
    pk.counts.reset()
    stats = run(PPO + ["--n-envs", "64", "--chunk-steps", "32", "--steps", "16384",
                       "--entropy-bonus", "0.5", "--chunks-per-dispatch", "2",
                       "--eval-every", "2", "--eval-steps", "30",
                       "--log-dir", str(tmp_path)] + CPU)
    # 16384 // (32 · 64 · 2) = 4 logging steps of 2 chunks.
    assert (pck.counts.plain_calls, pk.counts.plain_calls) == (8, 8)
    assert pck.counts.launches == pk.counts.launches == 0
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train = [r for r in rows if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [2 * 4096, 4 * 4096]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert stats["env_steps"] == 30 * 64


def test_cli_mxu_ppo_runs_without_fused_kernel():
    pck.counts.reset()
    stats = run(["island", "ppo-mlp", "--compiled", "--mxu", "--n-envs", "32",
                 "--chunk-steps", "8", "--steps", "256", "--eval-steps", "20",
                 "--cheat"] + CPU)
    assert pck.counts.plain_calls == 0 and stats["env_steps"] == 20 * 32


def test_cli_ppo_crmdp_runs_on_island():
    """``ppo-crmdp`` is ported: on island (no corrupt cells) it runs through
    the CLI on the MXU trainer and its attribution keeps the table finite."""
    stats = run(["island", "ppo-crmdp", "--compiled", "--mxu", "--n-envs", "16",
                 "--chunk-steps", "8", "--steps", "256", "--eval-steps", "20",
                 "--crmdp-lr", "1.0"] + CPU)
    assert stats["env_steps"] == 20 * 16 and np.isfinite(stats["mean_return"])


@pytest.mark.parametrize("argv, match", [
    (["island", "ppo-cnn", "--compiled", "--mxu", "--table-net"],
     "--table-net supports deep-q, ppo-mlp, and ppo-crmdp"),
    (["island", "ppo-cnn", "--compiled", "--mxu", "--fused-kernel"], "requires --table-net"),
    (["island", "single", "--compiled", "--mxu"], "--mxu requires --compiled and one of"),
    (PPO + ["--n-devices", "2"], "A.14"),
    (PPO + ["--n-layers", "3"], "two hidden layers"),
    (["island", "ppo-mlp", "--compiled", "--mxu", "--fused-kernel"], "requires --table-net"),
    (PPO + ["--chunk-steps", "40"], "--chunk-steps 40 must be a multiple of 16"),
])
def test_cli_ppo_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + CPU)


@pytest.mark.parametrize("argv, kernels", [
    (PPO + ["--mxu-parity"], True),
    (["island", "ppo-cnn", "--compiled", "--mxu"], False),
])
def test_cli_ppo_runs_what_was_refused(argv, kernels):
    """Once refused (ROADMAP A.10): ``--mxu-parity`` beside ``--fused-kernel``
    (which the reference's fused trainer ignores: B5 and B6 carry every
    chunk) and ``ppo-cnn`` on the MXU trainer (no kernel). Each trains a
    finite loss."""
    pck.counts.reset()
    pk.counts.reset()
    stats = run(argv + ["--n-envs", "16", "--chunk-steps", "16", "--steps", "512",
                        "--eval-steps", "100"] + CPU)
    assert pck.counts.plain_calls == pk.counts.plain_calls == (2 if kernels else 0)
    assert stats["env_steps"] == 100 * 16 and np.isfinite(stats["mean_return"])


@pytest.mark.parametrize("argv", [["island", "ppo-mlp"], ["island", "ppo-mlp", "--compiled"]])
def test_cli_ppo_runs_on_the_array_engine(argv):
    """Once refused (ROADMAP A.10): the base ``PPOTrainer`` over the array
    engine, on the uncompiled env and on a ``CompiledEnv``."""
    stats = run(argv + ["--n-envs", "16", "--chunk-steps", "8", "--steps", "256",
                        "--eval-steps", "100"] + CPU)
    # Every lane ends an episode inside 100 eval steps (the timeout).
    assert stats["env_steps"] == 100 * 16 and np.isfinite(stats["mean_return"])


def test_ppo_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cenv = make_env("island", compiled=True, device="cpu")
    for call in (
        lambda: PPOAgent(cenv).init(),
        lambda: run(PPO + ["--n-envs", "8", "--chunk-steps", "16", "--steps", "128"]),
        lambda: convert.ppo_state_from_jax({"params": {}}, 0, [], [], 0),
    ):
        with pytest.raises(RuntimeError, match="--platform cpu"):
            call()
