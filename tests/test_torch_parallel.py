"""The port's data-parallel runtime (``safe_grid_agents_torch/parallel``) on
gloo ranks of the CPU.

Processes and time limits: the W = 1 tests run in this process as the one
rank of a fresh group (``launch.single_rank``); every W = 2 test spawns 2
ranks (``launch.spawn``, one CPU thread each), with a join timeout of
``TIMEOUT`` s (the CLI runs: ``launch.JOIN_TIMEOUT``, set for every test),
past which the children are killed. Spawned ranks import the port and never JAX
(``tools/dp_cases.py`` holds what they run).

* ``DPTrainer`` at W = 1 is bitwise the unwrapped trainer over a chunk on the
  same generator, for the eight families (base and MXU tabular, DQN with PER
  and double-Q, the MXU DQN scan, base and MXU PPO, base and MXU CRMDP);
* at W = 2 every replicated leaf (the learner state but the rank's replay
  ring, the summed stats, the loss) is bitwise equal on both ranks;
* each collective site on handed-over inputs against the JAX function under
  ``shard_map`` on a 2-device mesh of the conftest's CPU devices, with
  ``tests/test_torch_array_learners.py``'s tolerances: Q atol 1e-4; the DQN
  update's params, target and moments rtol 2e-4 / atol 1e-6 and its loss
  rtol 2e-5; whitening atol 1e-6; the PPO optimize's params rtol 2e-4 / atol
  2e-6, μ rtol 2e-4 / atol 1e-6 and loss rtol 2e-5 / atol 1e-6; the CRMDP
  corruption step atol 1e-6;
* twins of ``tests/test_dp.py`` at W = 2, and of its two CLI runs with
  ``--n-devices 2 --platform cpu``;
* the CLI's refusals.
"""
import operator
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from safe_grid_agents_tpu.agents.crmdp import PPOCRMDPAgent as JaxCRMDPAgent  # noqa: E402
from safe_grid_agents_tpu.agents.dqn import DQNAgent as JaxDQNAgent  # noqa: E402
from safe_grid_agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent  # noqa: E402
from safe_grid_agents_tpu.agents.tabular import TabularQAgent as JaxTabularQAgent  # noqa: E402
from safe_grid_agents_tpu.agents.tabular import TabularQState as JaxTabularQState  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import TableState as JaxTableState  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.parallel import DATA_AXIS  # noqa: E402
from safe_grid_agents_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from safe_grid_agents_tpu.parallel.dp import _astate_specs  # noqa: E402
from safe_grid_agents_tpu.training.ppo import _whiten as jax_whiten  # noqa: E402
from safe_grid_agents_tpu.training.ppo_mxu import MXUPPOTrainer as JaxMXUPPOTrainer  # noqa: E402
from safe_grid_agents_tpu.training.tabular_mxu import _learn_matmul  # noqa: E402
from safe_grid_agents_tpu.types import Experience as JaxExperience  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.cli.main import run  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.parallel import launch, make_mesh, multihost  # noqa: E402
from safe_grid_agents_torch.parallel.dp import DPTrainer, local_target, rank_seed  # noqa: E402
from safe_grid_agents_torch.parallel.mesh import DataGroup  # noqa: E402
from safe_grid_agents_torch.tools import dp_cases  # noqa: E402
from safe_grid_agents_torch.training import (  # noqa: E402
    FusedDQNTrainer, FusedPPOTrainer, FusedTabularQTrainer,
)
from safe_grid_agents_torch.training.ppo_mxu import tile_geometry  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 120  # seconds for one spawn of 2 ranks
W = 2
CPU = ["--platform", "cpu"]
DQN_TOL = dict(rtol=2e-4, atol=1e-6)
PPO_TOL = dict(params=dict(rtol=2e-4, atol=2e-6), mu=dict(rtol=2e-4, atol=1e-6),
               loss=dict(rtol=2e-5, atol=1e-6))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _two_device_mesh():
    return jax_make_mesh(n_data=W, devices=jax.devices()[:W])


@pytest.fixture(autouse=True)
def _bounded_spawns(monkeypatch):
    """Every spawn this process makes, the CLI's too, is killed past TIMEOUT."""
    monkeypatch.setattr(launch, "JOIN_TIMEOUT", TIMEOUT)


@pytest.fixture
def one_rank():
    with launch.single_rank():
        yield make_mesh()


# ---- groups, launcher, local ranks ------------------------------------------------------

def test_make_mesh_describes_the_joined_group(one_rank):
    g = one_rank
    assert (g.world_size, g.rank, g.backend, g.device) == (1, 0, "gloo", torch.device("cpu"))
    assert g.group is None and g.lanes(8) == slice(0, 8)
    with pytest.raises(ValueError, match="A.14b"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match="2 data ranks"):
        make_mesh(n_data=2)


def test_make_mesh_needs_a_joined_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()


def test_multihost_without_launcher_variables_is_a_noop(monkeypatch):
    for k in multihost.LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    assert not multihost.launcher_present()
    assert multihost.ensure_initialized("cpu") is False and multihost.is_primary()
    assert (multihost.backend_for("cpu"), multihost.backend_for("cuda")) == ("gloo", "nccl")


def test_rank_seeds_and_local_eval_targets():
    seeds = {rank_seed(0, r) for r in range(4)} | {rank_seed(1, 0)}
    assert len(seeds) == 5 and rank_seed(3, 1) == rank_seed(3, 1)
    # ceil: W ranks cover the global target.
    assert [local_target(e, 4) for e in (None, 1, 8, 9)] == [None, 1, 2, 3]


@pytest.mark.parametrize("explicit", [True, False])
def test_spawn_kills_ranks_past_the_timeout(explicit, monkeypatch):
    """The bound given to the call, or else ``launch.JOIN_TIMEOUT``."""
    if not explicit:
        monkeypatch.setattr(launch, "JOIN_TIMEOUT", 4)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        launch.spawn(time.sleep, W, (60,), timeout=4 if explicit else None)
    assert time.monotonic() - t0 < 30


def test_spawn_raises_a_rank_error():
    with pytest.raises(Exception, match="ZeroDivisionError"):
        launch.spawn(operator.truediv, W, (1, 0), timeout=TIMEOUT)


def test_dp_trainer_refusals():
    group = DataGroup(group=None, world_size=3, rank=0, device=torch.device("cpu"),
                      backend="gloo")
    with pytest.raises(ValueError, match="not divisible by 3"):
        DPTrainer(dp_cases.build_family("ppo", "cpu"), group)
    with pytest.raises(ValueError, match="does not split"):
        DPTrainer(dp_cases.build_family("dqn", "cpu", n_envs=24), group)
    cenv = make_env("shift", compiled=True, device="cpu")
    fused = FusedTabularQTrainer(dp_cases.build_family("tabular-mxu", "cpu").agent,
                                 VecEnv(cenv, 24))
    with pytest.raises(ValueError, match="single-device"):
        DPTrainer(fused, group)


@pytest.mark.parametrize("family", ["dqn-mxu", "ppo-mxu"])
def test_fused_updates_refuse_a_group(family):
    """Past ``DPTrainer``'s refusal, the fused DQN and PPO updates raise
    alike when handed a group (neither falls back to another path)."""
    group = DataGroup(group=None, world_size=2, rank=0, device=torch.device("cpu"),
                      backend="gloo")
    base = dp_cases.build_family(family, "cpu")
    if family == "dqn-mxu":
        update = FusedDQNTrainer(base.agent, base.vec)._update_scan
        args = (None, None, 1)
    else:
        update = FusedPPOTrainer(base.agent, base.vec).optimize_fast
        args = (None, None, None, 1)
    with pytest.raises(ValueError, match="single-device"):
        update(*args, group=group)


# ---- DP correctness: W = 1 bitwise, W = 2 replicated ------------------------------------

@pytest.mark.parametrize("family", dp_cases.FAMILIES)
def test_dp_at_one_rank_is_the_unwrapped_trainer(family, one_rank):
    """Learner state, lanes, replay ring, stats and loss bitwise after a
    chunk (DQN after its warmup) from the same generator."""
    assert dp_cases.one_rank_diff(family, one_rank) == []


@pytest.fixture(scope="module")
def replicated():
    return launch.spawn(dp_cases.replicated, W, timeout=TIMEOUT)


@pytest.mark.parametrize("family", dp_cases.FAMILIES)
def test_dp_keeps_the_replicated_state_identical_across_ranks(family, replicated):
    r0, r1 = replicated[0][family], replicated[1][family]
    assert sorted(r0) == sorted(r1)
    assert int(r0["lanes"]) == dp_cases.N_ENVS // W
    assert float(r0["stats/env_steps"]) == dp_cases.T_CHUNK * dp_cases.N_ENVS
    for k in r0:
        assert torch.equal(r0[k], r1[k]), (family, k)


# ---- each collective site against the JAX function under shard_map ----------------------

def _site_cases():
    """Handed-over inputs of every site, and the JAX side's results."""
    rng = np.random.default_rng(7)
    mesh = _two_device_mesh()
    cases, want = {}, {}

    def shmap(f, in_specs, out_specs):
        return jax.jit(shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))

    def cat(name, ranks, axis=0):
        return jnp.asarray(np.concatenate([r[name] for r in ranks], axis))

    # Tabular learn and the MXU accumulate (one-hot matmuls) on the same step.
    jenv = jax_make_env("shift")
    S, A, n = jenv.num_states, 4, 16
    lr = 0.3
    ranks = [dict(s_idx=rng.integers(0, 6, n).astype(np.int32),
                  actions=rng.integers(0, A, n).astype(np.int32),
                  rewards=rng.normal(size=n).astype(np.float32),
                  next_idx=rng.integers(0, S, n).astype(np.int32),
                  dones=rng.random(n) < 0.2) for _ in range(W)]
    q = rng.normal(size=(S, A)).astype(np.float32)
    cases["tabular"] = dict(lr=lr, q=q, step=100, ranks=ranks)
    jagent = JaxTabularQAgent(jenv, lr=lr)
    args = [cat(k, ranks) for k in ("s_idx", "actions", "rewards", "next_idx", "dones")]
    lanes = (P(DATA_AXIS),) * 5
    for name, learn in (("tabular", jagent.learn),
                        ("tabular-mxu", lambda st, *a, **k: _learn_matmul(jagent, st, *a, **k))):
        def f(q, step, *a, learn=learn):
            st = learn(JaxTabularQState(q=q, step=step), *a, axis_name=DATA_AXIS)
            return st.q, st.step
        want[name] = shmap(f, (P(), P()) + lanes, (P(), P()))(jnp.asarray(q), jnp.int32(100),
                                                             *args)

    # The DQN update: each rank's ring, the reference's params and Adam state,
    # the slots each shard's key samples.
    jc = jax_make_env("sokoban", compiled=True)
    C, B = 64, 32
    kw = dict(lr=1e-3, batch_size=B, sync_every=3, double_q=True, hidden=(32, 32), table=True)
    jagent = JaxDQNAgent(jc, replay_capacity=W * C, **kw)
    jstate = jagent.init(jax.random.PRNGKey(5))
    reach = np.asarray(jc.reachable) if hasattr(jc, "reachable") else np.arange(jc.num_states)
    rings = []
    for _ in range(W):
        rings.append({"state": {"idx": rng.choice(reach, C).astype(np.int32),
                                "t": rng.integers(0, 50, C).astype(np.int32)},
                      "next_state": {"idx": rng.choice(reach, C).astype(np.int32),
                                     "t": rng.integers(0, 50, C).astype(np.int32)},
                      "action": rng.integers(0, 4, C).astype(np.int32),
                      "reward": rng.normal(size=C).astype(np.float32),
                      "done": rng.random(C) < 0.1})
    storage = JaxExperience(
        state=JaxTableState(idx=cat("idx", [r["state"] for r in rings]),
                            t=cat("t", [r["state"] for r in rings])),
        action=cat("action", rings), reward=cat("reward", rings),
        next_state=JaxTableState(idx=cat("idx", [r["next_state"] for r in rings]),
                                 t=cat("t", [r["next_state"] for r in rings])),
        done=cat("done", rings))
    jstate = jstate.replace(buffer=jstate.buffer.replace(storage=storage, idx=jnp.int32(0),
                                                         size=jnp.int32(C)))
    adam = jstate.opt_state[0]
    cases["dqn"] = dict(agent=dict(replay_capacity=C, **kw), state=(
        _np_tree(jstate.params), _np_tree(jstate.target_params), int(adam.count),
        _np_tree(adam.mu), _np_tree(adam.nu), int(jstate.step), int(jstate.updates)),
        ranks=[dict(ring=dict(storage=r, idx=0, size=C), slots=[]) for r in rings])
    specs = _astate_specs(jstate)
    update = shmap(lambda st, k: jagent.update(st, k[0], axis_name=DATA_AXIS),
                   (specs, P(DATA_AXIS)), (specs, P()))
    losses = []
    for u in range(4):
        keys = jax.random.split(jax.random.PRNGKey(200 + u), W)
        for r in range(W):
            cases["dqn"]["ranks"][r]["slots"].append(
                np.asarray(jax.random.randint(keys[r], (B,), 0, C)).astype(np.int64))
        jstate, jloss = update(jstate, keys)
        losses.append(float(jloss))
    want["dqn"] = (jstate, np.array(losses, np.float32))

    # Whitening by the global moments.
    x = [(3 * rng.normal(size=(8, 16)) + 1).astype(np.float32) for _ in range(W)]
    cases["whiten"] = dict(ranks=x)
    want["whiten"] = np.asarray(shmap(lambda v: jax_whiten(v, DATA_AXIS), P(None, DATA_AXIS),
                                      P(None, DATA_AXIS))(jnp.asarray(np.concatenate(x, 1))))

    # The PPO optimize (the MXU trainer's fast mode): each rank's flat batch
    # and the tile permutations of its shard's key.
    jc = jax_make_env("island", compiled=True)
    kw = dict(net="table", epochs=2, n_minibatches=4, hidden=(32, 32))
    jtr = JaxMXUPPOTrainer(JaxPPOAgent(jc, **kw), MXUVecEnv(jc, 8))
    jstate, _ = jtr.init(jax.random.PRNGKey(0))
    Bl, coef = 128, 0.05
    reach = np.arange(jc.num_states)
    flats = [dict(idx=rng.choice(reach, Bl).astype(np.int32),
                  actions=rng.integers(0, 4, Bl).astype(np.int32),
                  old_logp=np.log(rng.uniform(0.1, 0.6, Bl)).astype(np.float32),
                  advantages=rng.normal(size=Bl).astype(np.float32),
                  returns=(10 * rng.normal(size=Bl)).astype(np.float32)) for _ in range(W)]
    keys = jax.random.split(jax.random.PRNGKey(11), W)
    _, n_tiles, _ = tile_geometry(Bl, 4)
    for r, f in enumerate(flats):
        f["perms"] = np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(keys[r], e), n_tiles)) for e in range(2)]).astype(np.int64)
    adam = jstate.opt_state[1][0]
    cases["ppo"] = dict(agent=kw, coef=coef, ranks=flats, state=(
        _np_tree(jstate.params), int(adam.count), np.asarray(adam.mu), np.asarray(adam.nu), 0))
    jflat = {"states": JaxTableState(idx=cat("idx", flats),
                                     t=jnp.zeros(W * Bl, jnp.int32)),
             **{k: cat(k, flats) for k in ("actions", "old_logp", "advantages", "returns")}}
    opt = shmap(lambda st, fl, k: jtr.optimize_fast(st, fl, k[0], Bl, axis_name=DATA_AXIS,
                                                     entropy_coef=jnp.float32(coef)),
                (P(), P(DATA_AXIS), P(DATA_AXIS)), (P(), P(), P()))
    want["ppo"] = opt(jstate, jflat, keys)

    # The CRMDP attribution step.
    jc = jax_make_env("corners", compiled=True)
    jagent = JaxCRMDPAgent(jc, net="table", crmdp_lr=1.0)
    S = jc.num_states
    corr = (0.1 * rng.normal(size=S)).astype(np.float32)
    parts = [dict(next_idx=rng.integers(0, S, (8, 16)).astype(np.int32),
                  observed=rng.integers(-1, 3, (8, 16)).astype(np.float32),
                  hidden=rng.integers(-1, 2, (8, 16)).astype(np.float32)) for _ in range(W)]
    cases["crmdp"] = dict(lr=1.0, corruption=corr, ranks=parts)
    lanes = (P(None, DATA_AXIS),) * 3
    want["crmdp"] = np.asarray(shmap(
        lambda c, nx, o, h: jagent.update_corruption(c, nx, o, h, axis_name=DATA_AXIS),
        (P(),) + lanes, P())(jnp.asarray(corr), *(cat(k, parts, 1) for k in
                                                  ("next_idx", "observed", "hidden"))))
    return cases, want


@pytest.fixture(scope="module")
def sites():
    cases, want = _site_cases()
    return cases, want, launch.spawn(dp_cases.sites, W, (cases,), timeout=TIMEOUT)


SITES = ("tabular", "tabular-mxu", "dqn", "whiten", "ppo", "crmdp")


@pytest.mark.parametrize("site", SITES)
def test_collective_site_matches_jax_under_shard_map(site, sites):
    cases, want, ranks = sites
    for r, got in enumerate(ranks):
        if site in ("tabular", "tabular-mxu"):
            jq, jstep = want[site]
            np.testing.assert_allclose(got["tabular"]["q"].numpy(), np.asarray(jq), rtol=0,
                                       atol=1e-4)
            assert int(got["tabular"]["step"]) == int(jstep) == 100 + W * 16
        elif site == "dqn":
            jstate, jloss = want["dqn"]
            np.testing.assert_allclose(got["dqn"]["loss"].numpy(), jloss, rtol=2e-5, atol=0)
            adam = jstate.opt_state[0]
            for name, tree in (("params", jstate.params), ("target", jstate.target_params),
                               ("mu", adam.mu), ("nu", adam.nu)):
                ref = convert.qnet_params_from_flax(_np_tree(tree), True, "cpu")
                for k in ref:
                    np.testing.assert_allclose(got["dqn"][name][k].numpy(), ref[k].numpy(),
                                               err_msg=f"{name} {k}", **DQN_TOL)
        elif site == "whiten":
            k = cases["whiten"]["ranks"][r].shape[1]
            np.testing.assert_allclose(got["whiten"].numpy(), want["whiten"][:, r * k:(r + 1) * k],
                                       rtol=0, atol=1e-6)
        elif site == "ppo":
            jparams, jopt, jloss = want["ppo"]
            ref = convert.ac_params_from_flax(_np_tree(jparams), "cpu")
            for k in ref:
                np.testing.assert_allclose(got["ppo"]["params"][k].numpy(), ref[k].numpy(),
                                           err_msg=k, **PPO_TOL["params"])
            adam = jopt[1][0]
            np.testing.assert_allclose(got["ppo"]["mu"].numpy(), np.asarray(adam.mu),
                                       **PPO_TOL["mu"])
            np.testing.assert_allclose(float(got["ppo"]["loss"]), float(jloss),
                                       **PPO_TOL["loss"])
            assert int(got["ppo"]["count"]) == int(adam.count) == 8
        else:
            np.testing.assert_allclose(got["crmdp"].numpy(), want["crmdp"], rtol=0, atol=1e-6)


# ---- twins of tests/test_dp.py at W = 2 -------------------------------------------------

@pytest.fixture(scope="module")
def twins():
    return launch.spawn(dp_cases.twins, W, timeout=TIMEOUT)


def test_tabular_dp_learns_shift(twins):
    for r in twins:
        assert r["world"] == W
        assert r["tabular_eval"]["mean_return"] > 38.0, r["tabular_eval"]
        assert np.isfinite(r["tabular_q_sum"]) and r["tabular_q_sum"] == twins[0]["tabular_q_sum"]


def test_ppo_dp_chunk(twins):
    for r in twins:
        assert np.isfinite(r["ppo"]["loss"]) and r["ppo"] == twins[0]["ppo"]
        assert r["ppo"]["env_steps"] == 16 * 64  # global, summed over the ranks


def test_dqn_dp_chunk_with_sharded_replay(twins):
    for r in twins:
        # Each rank owns a 4096/2 ring; 16 warmup steps push its 32 lanes.
        assert r["dqn"]["capacity"] == 4096 // W and r["dqn"]["size"] == 16 * 32
        assert np.isfinite(r["dqn"]["loss"]) and r["dqn"]["loss"] == twins[0]["dqn"]["loss"]


def test_crmdp_dp_chunk(twins):
    for r in twins:
        assert np.isfinite(r["crmdp"]["loss"])
        assert torch.isfinite(r["crmdp"]["corruption"]).all()
        assert torch.equal(r["crmdp"]["corruption"], twins[0]["crmdp"]["corruption"])


def test_prioritized_dqn_dp_sharded_priorities(twins):
    """PER under DP: each rank's priorities belong to its own ring of
    4096/2 slots; the warmup fills 512 of them at the entry priority (≥ 1),
    the rest stay 0, and the train chunk's pushes stay inside the ring."""
    for r in twins:
        rec = r["dqn_per"]
        p = rec["priorities_warmup"]
        assert p.shape == (4096 // W,) and rec["size"] == 512
        assert bool((p[:512] >= 1.0).all()) and bool((p[512:] == 0.0).all())
        p = rec["priorities_train"]
        assert bool((p[:1024] > 0.0).all()) and bool((p[1024:] == 0.0).all())
        assert np.isfinite(rec["loss"])


def test_cli_multi_device_non_dqn():
    """A warmup-less agent through ``--n-devices 2`` on local gloo ranks."""
    stats = run(["shift", "ppo-mlp", "--n-devices", "2", "--n-envs", "64", "--steps", "4096",
                 "--chunk-steps", "8", "--eval-every", "100", "--eval-steps", "10"] + CPU)
    assert "mean_return" in stats and stats["env_steps"] == 10 * 64


def test_cli_multi_device_dqn():
    stats = run(["sokoban", "deep-q", "--n-devices", "2", "--n-envs", "64", "--steps", "4096",
                 "--chunk-steps", "8", "--eval-every", "100", "--eval-steps", "10",
                 "--replay-capacity", "4096", "--batch-size", "64", "--warmup-steps", "16",
                 "--prioritized"] + CPU)
    assert "mean_return" in stats and stats["env_steps"] == 10 * 64


@pytest.mark.parametrize("argv, match", [
    (["shift", "tabular-q", "--compiled", "--mxu", "--fused-kernel"], "single-device"),
    (["sokoban", "deep-q", "--compiled", "--mxu", "--fused-kernel"], "single-device"),
    (["island", "ppo-mlp", "--compiled", "--mxu", "--table-net", "--fused-kernel"],
     "single-device"),
    (["corners", "ppo-crmdp", "--compiled", "--mxu", "--table-net", "--fused-kernel"],
     "single-device"),
    (["shift", "ppo-mlp", "--tp", "2"], "A.14b"),
    (["shift", "tabular-q", "--checkpoint-dir", "unused"], "A.14b"),
    (["shift", "tabular-q", "--n-envs", "63"], "multiple of --n-devices"),
])
def test_cli_multi_device_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + ["--n-devices", "2"] + CPU)


def test_cli_refuses_more_cards_than_are_visible():
    """On cuda one rank runs per card, never falling back to the CPU."""
    with pytest.raises(SystemExit, match=r"card\(s\) are visible"):
        run(["shift", "tabular-q", "--n-devices", "2"])
