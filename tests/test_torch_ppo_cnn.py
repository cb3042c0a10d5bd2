"""``ppo-cnn`` and the PPO parity mode against the JAX package.

* The CNN: ``ActorCriticCNN`` with flax's params converted (``Conv_i`` in
  HWIO, ``Dense_i``) matches flax's ``ActorCriticCNN`` on a rectangular grid
  with inputs that differ along H, W and C — forward atol 1e-5, gradients
  rtol/atol 1e-4 — so the flatten order (channels last, as the reference's
  NHWC trunk) and the converted ``Dense_0.kernel`` mean the same thing. Its
  own init has flax's scale (a convolution's fan-in is 3·3·C_in).
* ``PPOTrainer.optimize`` with the CNN on the reference's permutations
  matches the reference's optimize (params rtol 2e-4 / atol 2e-6, μ rtol
  2e-4 / atol 1e-6, loss rtol 2e-5 / atol 1e-6, the Adam count equal).
* The parity mode: ``MXUPPOTrainer(mode="parity").optimize`` on one flat
  batch and the reference's element permutations matches the reference's
  parity optimize (the same tolerances; the CNN there by minibatch, on
  its loss and gradients); and a parity chunk is bitwise the
  base ``PPOTrainer``'s over ``ArrayVecEnv`` on the same compiled env and
  generator (``tests/test_ppo_mxu.py:37``, ``:68``: island, absent and
  tomato with the table, MLP and CNN nets; CRMDP on corners).
* The CLI: ``ppo-cnn`` on both engines, ``--mxu-parity`` on both MXU
  trainers, the reference's refusals of ``ppo-cnn --fused-kernel`` without
  ``--table-net`` and of ``--table-net`` with ``ppo-cnn``.
* A short learning run: PPO-CNN camps the corrupt corner
  (``tests/test_agents.py:421``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.agents.networks import ActorCriticCNN as JaxCNN  # noqa: E402
from safe_grid_agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import TableState as JaxTableState  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.training.ppo import PPOTrainer as JaxPPOTrainer  # noqa: E402
from safe_grid_agents_tpu.training.ppo_mxu import MXUPPOTrainer as JaxMXUPPOTrainer  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.crmdp import PPOCRMDPAgent  # noqa: E402
from safe_grid_agents_torch.agents.networks import ActorCriticCNN  # noqa: E402
from safe_grid_agents_torch.agents.ppo import PPOAgent, PPOCNNAgent, PPOState  # noqa: E402
from safe_grid_agents_torch.cli.main import run  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.array_vec import ArrayVecEnv  # noqa: E402
from safe_grid_agents_torch.envs.compiled import TableState  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.training import (  # noqa: E402
    CRMDPTrainer, MXUCRMDPTrainer, MXUPPOTrainer, PPOTrainer, stats_to_host,
)
from test_torch_array_engine import engines, reset_pair  # noqa: E402
from test_torch_array_learners import _perms, _ppo_flat  # noqa: E402

torch.set_num_threads(1)
PPO_TOL = dict(params=dict(rtol=2e-4, atol=2e-6), mu=dict(rtol=2e-4, atol=1e-6),
               loss=dict(rtol=2e-5, atol=1e-6))
CPU = ["--platform", "cpu"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), err_msg=what,
                               **tol)


# ---- the net -----------------------------------------------------------------------

def test_cnn_forward_and_gradients_match_flax():
    """P = 3 planes of a 5 × 7 grid, each plane, row and column scaled
    differently; 6 actions, hidden 24."""
    P, H, W, A, hidden = 3, 5, 7, 6, 24
    rng = np.random.default_rng(0)
    obs = (rng.normal(size=(10, P, H, W))
           * np.arange(1, P + 1)[:, None, None] * np.linspace(0.5, 2.0, H)[:, None]
           * np.linspace(1.5, 0.2, W)).astype(np.float32)
    jnet = JaxCNN(n_actions=A, hidden=hidden)
    tree = _np_tree(jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs)))
    net = ActorCriticCNN((P, H, W), A, hidden=hidden)
    params = convert.ac_params_from_flax(tree, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in net.named_parameters()}
    assert params["Conv_0.kernel"].shape == (3, 3, P, 32)
    c1 = rng.normal(size=(10, A)).astype(np.float32)
    c2 = rng.normal(size=10).astype(np.float32)

    def jloss(p):
        logits, value = jnet.apply(p, jnp.asarray(obs))
        return (logits * c1).sum() + (value * c2).sum(), (logits, value)

    (_, (jl, jv)), jgrad = jax.value_and_grad(jloss, has_aux=True)(tree)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    logits, value = net.apply(leaves, torch.from_numpy(obs))
    _close(logits, jl, "logits", rtol=0.0, atol=1e-5)
    _close(value, jv, "value", rtol=0.0, atol=1e-5)
    loss = (logits * torch.from_numpy(c1)).sum() + (value * torch.from_numpy(c2)).sum()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want = convert.ac_params_from_flax(_np_tree(jgrad), "cpu")
    for k in want:
        _close(grads[k], want[k].numpy(), f"grad {k}", rtol=1e-4, atol=1e-4)
    # Leading dims pass through: [2, 5, P, H, W] → logits [2, 5, A], value [2, 5].
    lg, vl = net.apply(params, torch.from_numpy(obs).reshape(2, 5, P, H, W))
    assert lg.shape == (2, 5, A) and vl.shape == (2, 5)
    torch.testing.assert_close(lg.reshape(10, A), logits.detach(), rtol=0.0, atol=0.0)


def test_cnn_convolution_equals_autograd_conv2d():
    """``Conv`` runs ``F.conv2d`` through its own autograd function (cuDNN's
    TF32 off on the card in both passes); on the CPU its forward and its
    gradients are bitwise those of ``F.conv2d`` under autograd."""
    from safe_grid_agents_torch.agents.networks import Conv

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 3, 5, 7)).astype(np.float32))
    conv = Conv(3, 8)
    kernel = torch.from_numpy(rng.normal(size=(3, 3, 3, 8)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(4, 8, 5, 7)).astype(np.float32))
    outs = []
    for fn in (lambda xx, k, b: torch.func.functional_call(conv, {"kernel": k, "bias": b},
                                                           (xx,)),
               lambda xx, k, b: torch.nn.functional.conv2d(xx, k.permute(3, 2, 0, 1), b,
                                                           padding=1)):
        leaves = [t.clone().requires_grad_(True) for t in (x, kernel, bias)]
        y = fn(*leaves)
        outs.append((y.detach(), torch.autograd.grad((y * c).sum(), leaves)))
    (y0, g0), (y1, g1) = outs
    assert torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_cnn_agent_init_has_flax_scale():
    """The port's own init: flax's shapes, and each kernel's spread within
    10% of flax's (a convolution's fan-in is 3·3·C_in, not 3)."""
    env, jenv = make_env("shift"), jax_make_env("shift")
    agent, jagent = PPOCNNAgent(env, hidden=(64,)), JaxPPOAgent(jenv, net="cnn", hidden=(64,))
    assert agent.name == "ppo-cnn" and agent.net_kind == "cnn"
    tree = _np_tree(jagent.init(jax.random.PRNGKey(1)).params)
    own = agent.init("cpu", seed=1).params
    ref = convert.ac_params_from_flax(tree, "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in ref.items()} == agent.shapes
    for k, v in own.items():
        if k.endswith("kernel"):
            want = float(ref[k].std(unbiased=False))
            assert abs(float(v.std(unbiased=False)) - want) <= 0.1 * want, k
        else:
            assert float(v.abs().max()) == 0.0, k


def test_cnn_optimize_matches_jax():
    """Two rounds of ``PPOTrainer.optimize`` with the CNN (2 epochs × 4
    minibatches each) on one flat batch of shift states and the reference's
    permutations, from the reference's fresh params, then from the round's
    result."""
    vec, jvec = engines("shift")
    kw = dict(net="cnn", lr=1e-3, epochs=2, n_minibatches=4, entropy_bonus=0.05,
              hidden=(32,))
    agent, jagent = PPOAgent(vec.env, **kw), JaxPPOAgent(jvec.env, **kw)
    tr, jtr = PPOTrainer(agent, vec), JaxPPOTrainer(jagent, jvec)
    vs, jvs = reset_pair(vec, jvec, jax.random.PRNGKey(1))
    jstates, extra, B = _ppo_flat(jvec, jvs, np.random.default_rng(0), 6)
    jflat = {"states": jstates, **{k: jnp.asarray(v) for k, v in extra.items()}}
    from test_torch_array_learners import _port_record
    flat = {"states": _port_record(type(vs.env), jstates),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}
    _optimize_rounds(tr, jtr, agent, jagent, flat, jflat, B)


def _optimize_rounds(tr, jtr, agent, jagent, flat, jflat, B):
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


def _island_flat(B=144):
    """A flat batch of island index states and random PPO targets."""
    rng = np.random.default_rng(2)
    reach = make_env("island", compiled=True, device="cpu").reachable.numpy()
    idx = rng.choice(reach, B).astype(np.int32)
    t = rng.integers(0, 20, B).astype(np.int32)
    extra = dict(actions=rng.integers(0, 4, B).astype(np.int32),
                 old_logp=np.log(rng.uniform(0.1, 0.6, B)).astype(np.float32),
                 advantages=rng.normal(size=B).astype(np.float32),
                 returns=(10 * rng.normal(size=B)).astype(np.float32))
    jflat = {"states": JaxTableState(idx=jnp.asarray(idx), t=jnp.asarray(t)),
             **{k: jnp.asarray(v) for k, v in extra.items()}}
    flat = {"states": TableState(idx=torch.from_numpy(idx), t=torch.from_numpy(t)),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return flat, jflat


def test_cnn_island_minibatch_gradients_match_jax():
    """The CNN over island's one-hot planes, at the reference's init: the
    loss and its gradients on each minibatch of an element permutation
    (loss rtol 2e-5, gradients atol 1e-6; they agree to ~1.5e-7 at
    magnitudes up to 0.3). End to end, the optimize on these states parts
    from the reference at a few of Dense_0's 147,456 entries, whose
    gradients are float noise (|g| ~ 1e-10) that Adam's first step scales
    up to the learning rate: the check there is ill-posed, so the CNN's
    optimize is held end to end on shift (``test_cnn_optimize_matches_jax``)
    and here by minibatch."""
    cenv, jc = make_env("island", compiled=True, device="cpu"), jax_make_env("island",
                                                                             compiled=True)
    kw = dict(net="cnn", entropy_bonus=0.05, hidden=(32, 32))
    agent, jagent = PPOAgent(cenv, **kw), JaxPPOAgent(jc, **kw)
    flat, jflat = _island_flat()
    tree = jagent.init(jax.random.PRNGKey(7)).params
    params = convert.ac_params_from_flax(_np_tree(tree), "cpu")
    perm = _perms(jax.random.PRNGKey(30), 1, 144)[0]
    for i in range(4):
        take = perm[i * 36:(i + 1) * 36]
        jmb = jax.tree.map(lambda x: x[take.numpy()], jflat)
        mb = {k: (TableState(idx=v.idx[take], t=v.t[take]) if isinstance(v, TableState)
                  else v[take]) for k, v in flat.items()}
        jl, jg = jax.value_and_grad(lambda p: jagent.loss(p, jmb, jnp.float32(0.05)))(tree)
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = agent.loss(leaves, mb, torch.tensor(0.05))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        _close(loss, jl, f"minibatch {i} loss", **PPO_TOL["loss"])
        want = convert.ac_params_from_flax(_np_tree(jg), "cpu")
        for k in want:
            _close(grads[k], want[k].numpy(), f"minibatch {i} grad {k}", rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("net", ["table", "mlp"])
def test_parity_optimize_matches_jax(net):
    """``MXUPPOTrainer(mode="parity").optimize`` on island index states (a
    flat batch of 6 × 24) against the reference's parity mode."""
    N, B = 24, 144
    cenv, jc = make_env("island", compiled=True, device="cpu"), jax_make_env("island",
                                                                             compiled=True)
    kw = dict(net=net, lr=1e-3, epochs=2, n_minibatches=4, entropy_bonus=0.05,
              hidden=(32, 32))
    agent, jagent = PPOAgent(cenv, **kw), JaxPPOAgent(jc, **kw)
    tr = MXUPPOTrainer(agent, VecEnv(cenv, N), mode="parity")
    jtr = JaxMXUPPOTrainer(jagent, MXUVecEnv(jc, N), mode="parity")
    flat, jflat = _island_flat(B)
    assert tr.draw_perms(torch.Generator().manual_seed(0), B).shape == (2, B)
    _optimize_rounds(tr, jtr, agent, jagent, flat, jflat, B)


# ---- the parity chunk --------------------------------------------------------------

def _assert_chunks_equal(base, mxu, seed, T=12, n_chunks=3):
    gb = torch.Generator().manual_seed(seed)
    gm = torch.Generator().manual_seed(seed)
    ab, vb = base.init(seed=3, generator=gb)
    am, vm = mxu.init(seed=3, generator=gm)
    for c in range(n_chunks):
        ab, vb, sb, lb = base.train_chunk(ab, vb, gb, T)
        am, vm, sm, lm = mxu.train_chunk(am, vm, gm, T)
        assert torch.equal(lb, lm), c
        for f in ("episodes", "return_sum", "hidden_sum", "length_sum", "env_steps"):
            assert torch.equal(getattr(sb, f), getattr(sm, f)), (c, f)
        assert torch.equal(base.vec.state_index(vb), vm.idx), c
    for k in ab.params:
        assert torch.equal(ab.params[k], am.params[k]), k
    assert torch.equal(ab.mu, am.mu) and torch.equal(ab.nu, am.nu)
    assert int(ab.count) == int(am.count) and int(ab.step) == int(am.step)
    return ab, am


@pytest.mark.parametrize("alias", ["island", "absent", "tomato"])
@pytest.mark.parametrize("net", ["table", "mlp", "cnn"])
def test_parity_chunk_equals_the_base_trainer(alias, net):
    """Three chunks (N = 8, T = 12) of the parity mode against the base
    trainer over the array engine on the same compiled env: island's
    deterministic reset, absent's coin reset, tomato's drying."""
    cenv = make_env(alias, compiled=True, device="cpu")
    agent = PPOAgent(cenv, net=net, epochs=2, n_minibatches=2, hidden=(32, 32))
    _assert_chunks_equal(PPOTrainer(agent, ArrayVecEnv(cenv, 8)),
                         MXUPPOTrainer(agent, VecEnv(cenv, 8), mode="parity"), seed=11)


def test_crmdp_parity_chunk_equals_the_base_trainer():
    cenv = make_env("corners", compiled=True, device="cpu")
    agent = PPOCRMDPAgent(cenv, epochs=2, n_minibatches=2, crmdp_lr=1.0, hidden=(32, 32))
    ab, am = _assert_chunks_equal(CRMDPTrainer(agent, ArrayVecEnv(cenv, 8)),
                                  MXUCRMDPTrainer(agent, VecEnv(cenv, 8), mode="parity"),
                                  seed=13)
    assert torch.equal(ab.corruption, am.corruption)


def test_fast_and_parity_modes_differ_only_in_the_optimize():
    """The two modes share the collect; their permutations differ in kind
    (tiles of 32 elements against elements) and an unknown mode raises."""
    cenv = make_env("island", compiled=True, device="cpu")
    agent = PPOAgent(cenv, net="table", epochs=2, n_minibatches=2)
    fast = MXUPPOTrainer(agent, VecEnv(cenv, 64))
    parity = MXUPPOTrainer(agent, VecEnv(cenv, 64), mode="parity")
    assert fast.mode == "fast"
    g = torch.Generator().manual_seed(0)
    assert fast.draw_perms(g, 1024).shape == (2, 32)
    assert parity.draw_perms(g, 1024).shape == (2, 1024)
    with pytest.raises(ValueError, match="fast.*parity"):
        MXUPPOTrainer(agent, VecEnv(cenv, 8), mode="exact")


# ---- the CLI -------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["corners", "ppo-cnn"],
    ["shift", "ppo-cnn", "--compiled", "--mxu"],
    ["island", "ppo-mlp", "--compiled", "--mxu", "--table-net", "--mxu-parity"],
    ["corners", "ppo-crmdp", "--compiled", "--mxu", "--mxu-parity", "--crmdp-lr", "1.0"],
])
def test_cli_runs_ppo_cnn_and_the_parity_mode(argv):
    stats = run(argv + ["--n-envs", "16", "--steps", "1024", "--chunk-steps", "16",
                        "--eval-steps", "30"] + CPU)
    assert stats["env_steps"] == 30 * 16 and stats["episodes"] >= 0


def test_cli_ppo_cnn_preset_matches_the_reference():
    """``cli/presets.json``'s ppo-cnn entries are ``presets.yaml:23-41``,
    ``:43-54`` and ``:130-135`` key by key."""
    import json
    import os

    from safe_grid_agents_torch.cli import parsing

    with open(parsing.PRESETS_PATH) as f:
        presets = json.load(f)
    assert presets["shift"]["ppo-cnn"] == {
        "lr": 0.000216, "entropy-bonus": 0.3, "entropy-final": 0.0,
        "entropy-anneal-steps": 1000000, "n-hidden": 256, "n-minibatches": 8,
        "n-envs": 512, "chunk-steps": 32, "chunks-per-dispatch": 4, "steps": 1000000}
    assert presets["island"]["ppo-cnn"] == {
        "lr": 0.0005, "entropy-bonus": 0.5, "entropy-final": 0.0,
        "entropy-anneal-steps": 3000000, "n-envs": 1024, "chunk-steps": 64, "steps": 5000000}
    assert presets["corners"]["ppo-cnn"] == {
        "lr": 0.001, "entropy-bonus": 0.05, "n-envs": 64, "chunk-steps": 16, "steps": 80000}
    yaml_path = os.path.join(os.path.dirname(__file__), os.pardir, "safe_grid_agents_tpu",
                             "cli", "presets.yaml")
    text = open(yaml_path).read()
    assert "ppo-cnn" in text and "0.000216" in text


@pytest.mark.parametrize("argv, match", [
    (["island", "ppo-cnn", "--compiled", "--mxu", "--fused-kernel"], "requires --table-net"),
    (["island", "ppo-cnn", "--compiled", "--mxu", "--table-net"],
     "--table-net supports deep-q, ppo-mlp, and ppo-crmdp"),
])
def test_cli_ppo_cnn_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + CPU)


# ---- learning ------------------------------------------------------------------------

def test_ppo_cnn_camps_the_corrupt_corner():
    """``tests/test_agents.py:421``: PPO-CNN on corners (N = 64, 20 chunks
    of 16) finds the observed-optimal corrupt-corner camp."""
    env = make_env("corners")
    vec = ArrayVecEnv(env, 64, "cpu")
    tr = PPOTrainer(PPOCNNAgent(env, lr=1e-3, entropy_bonus=0.05), vec)
    g = torch.Generator().manual_seed(0)
    astate, vstate = tr.init(seed=0, generator=g)
    evals = []
    for i in range(20):
        astate, vstate, _, _ = tr.train_chunk(astate, vstate, g, 16)
        if i >= 17:
            _, es = tr.eval_chunk(astate, vec.reset(g), 25, generator=g)
            s = stats_to_host(es)
            evals.append((s["mean_return"], s["mean_hidden"]))
    ret, hid = max(evals)
    assert ret >= 30.0, f"PPO-CNN did not learn: {evals}"
    assert hid <= -10.0, f"hidden should reveal the hack: {evals}"
