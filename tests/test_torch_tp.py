"""The port's model axis (``safe_grid_agents_torch/parallel/tp.py``,
``--tp``) on gloo ranks of the CPU, held to the reference's
``tests/test_tp.py`` and ``tests/test_dp.py:146``.

One module-scoped spawn of 4 ranks (``launch.spawn``, one CPU thread each,
a join timeout of ``TIMEOUT`` s) runs ``tools/tp_cases.py::tp_jobs``: on
each rank the small cases of ``tp_cases.CASES`` unwrapped and under
``TPTrainer`` at (D 1, M 2), under ``DPTrainer`` at W 2 and under
``TPTrainer`` at (D 2, M 2); the sharded forward of JAX-initialised island
PPO parameters; the column-sharded matmul; and the CLI at
``--n-devices 4 --tp 2``. Spawned ranks import the port and never JAX.

* ``tp_param_specs`` against the JAX ``tp_param_specs`` on the same nets;
* the sharded forward against the JAX ``apply``, atol 1e-5;
* ``TPTrainer`` at (D 1, M 2) against the unwrapped trainer and at (D 2,
  M 2) against ``DPTrainer`` at W 2, within ``test_tp.py``'s tolerances
  (loss rtol 1e-4 / atol 1e-5, parameters rtol 2e-4 / atol 2e-5, episodes
  bitwise, ``return_sum`` rtol 1e-5), with shards of ``(d_in, h/2)``, on
  ``tp_cases.CASES``: PPO-MLP and PER deep-Q as the reference's, then the
  CNN, the table-folded CRMDP net and a 3-layer table Q net;
* the CLI's ``--tp`` run and its refusals.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")

from safe_grid_agents_tpu.agents.dqn import DQNAgent as JaxDQNAgent  # noqa: E402
from safe_grid_agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.parallel import tp_param_specs as jax_tp_param_specs  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.dqn import DQNAgent  # noqa: E402
from safe_grid_agents_torch.agents.ppo import PPOAgent, ravel, unravel  # noqa: E402
from safe_grid_agents_torch.cli.main import run  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.parallel import launch  # noqa: E402
from safe_grid_agents_torch.parallel.mesh import AxisGroup, DataGroup  # noqa: E402
from safe_grid_agents_torch.parallel.tp import (  # noqa: E402
    COL, COL_BIAS, ROW, TPPlan, TPTrainer, tp_param_specs,
)
from safe_grid_agents_torch.tools import tp_cases  # noqa: E402
from safe_grid_agents_torch.tools.dp_cases import build_family  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 240  # seconds for the spawn of 4 ranks
CPU = ["--platform", "cpu"]
CLI_TP = ["island", "ppo-mlp", "--n-envs", "32", "--steps", "2048", "--chunk-steps", "8",
          "--eval-every", "4", "--eval-steps", "12", "--n-devices", "4", "--tp", "2"] + CPU


@pytest.fixture(autouse=True)
def _bounded_spawns(monkeypatch):
    monkeypatch.setattr(launch, "JOIN_TIMEOUT", TIMEOUT)


def _jax_island_params(hidden=(64, 64)):
    agent = JaxPPOAgent(jax_make_env("island"), net="mlp", hidden=hidden)
    return jax.tree.map(np.asarray, agent.init(jax.random.PRNGKey(0)).params), agent


@pytest.fixture(scope="module")
def world():
    """The JAX side's inputs and outputs, and every rank's results."""
    tree, agent = _jax_island_params()
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((16,) + tuple(make_env("island").obs_shape)).astype(np.float32)
    logits, value = agent.net.apply(tree, obs)
    params = {k: v.cpu().numpy() for k, v in convert.ac_params_from_flax(tree, "cpu").items()}
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    jobs = {"cases": tp_cases.CASES, "forward": (params, obs), "matmul": (x, w),
            "cli": CLI_TP}
    ranks = launch.spawn(tp_cases.tp_jobs, 4, (jobs,), timeout=TIMEOUT)
    return {"ranks": ranks, "logits": np.asarray(logits), "value": np.asarray(value),
            "x": x, "w": w}


# ---- the spec table ------------------------------------------------------------------

def test_tp_param_specs_megatron_alternation():
    """tests/test_tp.py:29: Dense_0 column-parallel with its bias, Dense_1
    row-parallel, the heads replicated (absent from the table)."""
    agent = PPOAgent(make_env("island"), hidden=(64, 64))
    specs = tp_param_specs(dict(agent.net.named_parameters()))
    assert specs == {"Dense_0.kernel": COL, "Dense_0.bias": COL_BIAS, "Dense_1.kernel": ROW}


def _port_name(layer, leaf, qnet: bool, table: bool = False) -> str:
    if not qnet:
        return f"{layer}.{leaf}"
    first = 2 if table else 1  # the table net's Dense_0 is its w2
    return ("w" if leaf == "kernel" else "b") + str(int(layer.split("_")[1]) + first)


@pytest.mark.parametrize("net", ["island ppo-mlp", "island ppo-cnn", "sokoban q-mlp",
                                 "corners q-table-3", "corners ppo-table"])
def test_tp_param_specs_match_the_reference(net):
    alias, kind = net.split()
    key = jax.random.PRNGKey(0)
    # The reference's table reads shapes only: its params' shapes will do.
    if kind == "q-mlp":
        jtree = jax.eval_shape(JaxDQNAgent(jax_make_env(alias)).init_params, key)
        port = DQNAgent(make_env(alias)).net
    elif kind == "q-table-3":
        kw = dict(table=True, hidden=(32, 32, 32))
        jagent = JaxDQNAgent(jax_make_env(alias, compiled=True), **kw)
        jtree = jax.eval_shape(jagent.init_params, key)
        port = DQNAgent(make_env(alias, compiled=True, device="cpu"), **kw).net
        want = {_port_name(layer, leaf, True, True): tuple(spec)
                for (layer, leaf), spec in jax_tp_param_specs(jtree).items()}
        assert tp_param_specs(dict(port.named_parameters()), table=True) == want
        assert want == {"w2": COL, "b2": COL_BIAS, "w3": ROW}
        return
    elif kind == "ppo-table":
        jagent = JaxPPOAgent(jax_make_env(alias, compiled=True), net="table")
        jtree = jax.eval_shape(jagent.init, key).params
        port = PPOAgent(make_env(alias, compiled=True, device="cpu"), net="table").net
    else:
        jnet = "cnn" if kind == "ppo-cnn" else "mlp"
        hidden = (64, 64) if jnet == "mlp" else (128, 128)
        jagent = JaxPPOAgent(jax_make_env(alias), net=jnet, hidden=hidden)
        jtree = jax.eval_shape(jagent.init, key).params
        port = PPOAgent(make_env(alias), net=jnet, hidden=hidden).net
    want = {_port_name(layer, leaf, kind == "q-mlp"): tuple(spec)
            for (layer, leaf), spec in jax_tp_param_specs(jtree).items()}
    assert tp_param_specs(dict(port.named_parameters())) == want
    assert want  # every net shards its first dense kernel


@pytest.mark.parametrize("model_rank", [0, 1])
def test_shard_state_cuts_params_and_moments_alike(model_rank):
    """The counterpart of the reference's ``_leaf_spec``: params, target
    params and Adam's moments cut like their parameter (PPO's flat moments
    segment by segment), the rest (ring, counters) left as it is."""
    cpu = torch.device("cpu")
    model = AxisGroup(group=None, world_size=2, rank=model_rank, device=cpu, backend="gloo")
    agent = DQNAgent(make_env("sokoban"), hidden=(64, 64), replay_capacity=64,
                     prioritized=True)
    plan = TPPlan(agent.net, tp_param_specs(dict(agent.net.named_parameters())), model)
    whole = agent.init("cpu", seed=3)
    whole.mu = {k: torch.randn(v.shape) for k, v in whole.params.items()}
    mine = plan.shard_state(whole)
    cols, rows = slice(32 * model_rank, 32 * (model_rank + 1)), slice(None)
    for field in ("params", "target_params", "mu", "nu"):
        got, want = getattr(mine, field), getattr(whole, field)
        assert torch.equal(got["w1"], want["w1"][:, cols])
        assert torch.equal(got["b1"], want["b1"][cols])
        assert torch.equal(got["w2"], want["w2"][cols, rows])
        assert all(torch.equal(got[k], want[k]) for k in ("b2", "w3", "b3"))
    assert mine.buffer is whole.buffer and mine.count is whole.count

    ppo = PPOAgent(make_env("island"), hidden=(64, 64))
    plan = TPPlan(ppo.net, tp_param_specs(dict(ppo.net.named_parameters())), model)
    whole = ppo.init("cpu")
    whole.mu = torch.randn(whole.mu.shape)
    mine = plan.shard_state(whole)
    assert torch.equal(mine.mu, ravel(plan.shard_params(unravel(whole.mu, plan.shapes))))
    assert mine.mu.numel() == sum(v.numel() for v in mine.params.values())


# ---- the ranks ---------------------------------------------------------------------------

def test_tp_forward_matches_jax_apply(world):
    """JAX-initialised island PPO parameters, cut over 2 model ranks."""
    for rank in world["ranks"]:
        np.testing.assert_allclose(rank["forward"]["logits"].numpy(), world["logits"],
                                   atol=1e-5)
        np.testing.assert_allclose(rank["forward"]["value"].numpy(), world["value"],
                                   atol=1e-5)


@pytest.mark.parametrize("case", list(tp_cases.CASES))
@pytest.mark.parametrize("leg", ["D1 M2 vs unwrapped", "D2 M2 vs DP W2"])
def test_tp_trainer_matches_its_reference_run(world, case, leg):
    """Within TP_TOL; trajectories follow the generators, not the sharding,
    so episodes and env steps are equal."""
    got, want = ("tp12", "single") if leg.startswith("D1") else ("tp22", "dp2")
    for rank in world["ranks"]:
        c = tp_cases.compare(rank[case][got], rank[case][want])
        assert c["ok"], (rank["rank"], c)


@pytest.mark.parametrize("case", ["ppo", "dqn-per"])
def test_tp_state_is_sharded_over_model(world, case):
    """test_tp.py:55: kernels and Adam's moments are cut over ``model``
    (shards ``(d_in, h/2)``), the replay ring over ``data``."""
    rec = world["ranks"][0][case]
    shapes = rec["shapes"]
    if case == "ppo":
        d_in = 288
        assert shapes["params/Dense_0.kernel"] == (d_in, 32)
        assert shapes["params/Dense_0.bias"] == (32,)
        assert shapes["params/Dense_1.kernel"] == (32, 64)
        assert shapes["params/Dense_2.kernel"] == (64, 4)
        whole = sum(int(np.prod(v.shape)) for k, v in rec["single"]["state"].items()
                    if k.startswith("params/"))
        assert shapes["mu/flat"] == (whole - (d_in * 32 + 32 + 32 * 64),)
    else:
        assert shapes["params/w1"] == shapes["mu/w1"] == (144, 32)
        assert shapes["params/b1"] == (32,) and shapes["params/w2"] == (32, 64)
        # Each data rank's ring holds capacity / D.
        assert rec["tp12"]["state"]["buffer/priorities"].shape == (512,)
        assert rec["tp22"]["state"]["buffer/priorities"].shape == (256,)
    assert world["ranks"][0][case]["lanes22"] == 16


@pytest.mark.parametrize("case", list(tp_cases.CASES))
def test_tp_model_group_holds_one_state(world, case):
    """The two ranks of a model group end with the same whole state, bit for
    bit: every replicated quantity is computed alike on both."""
    r = world["ranks"]
    for a, b in ((r[0], r[1]), (r[2], r[3])):
        for leg in ("tp12", "tp22"):
            for k, v in a[case][leg]["state"].items():
                assert torch.equal(v, b[case][leg]["state"][k]), (leg, k)


def test_model_axis_column_matmul(world):
    """tests/test_dp.py:146 on a (2, 2) grid: the activations' rows over
    ``data``, the weight's columns over ``model``."""
    want = np.maximum(world["x"] @ world["w"], 0)
    for rank in world["ranks"]:
        np.testing.assert_allclose(rank["matmul"].numpy(), want, rtol=2e-4, atol=1e-4)


def test_cli_tp(world):
    """tests/test_tp.py:86 at --n-devices 4 --tp 2."""
    finals = [rank["cli"] for rank in world["ranks"]]
    assert all(np.isfinite(f["mean_return"]) for f in finals)
    assert all(f == finals[0] for f in finals)


# ---- refusals ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv, match", [
    # tests/test_cli.py:595
    (["island", "ppo-mlp", "--compiled", "--mxu", "--tp", "2", "--n-devices", "4",
      "--n-envs", "8", "--steps", "64"], "not supported"),
    (["shift", "tabular-q", "--tp", "2", "--n-devices", "4"], "deep agent"),
    (["island", "ppo-mlp", "--compiled", "--mxu", "--table-net", "--fused-kernel", "--tp",
      "2", "--n-devices", "2"], "single-device"),
    (["island", "ppo-mlp", "--tp", "2", "--n-devices", "3"], "multiple of --tp"),
])
def test_cli_tp_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + CPU)


def test_tp_trainer_refusals():
    cpu = torch.device("cpu")
    no_model = DataGroup(group=None, world_size=1, rank=0, device=cpu, backend="gloo")
    with pytest.raises(ValueError, match="model axis"):
        TPTrainer(build_family("ppo", "cpu"), no_model)
    with pytest.raises(ValueError, match="deep trainers"):
        TPTrainer(build_family("ppo-mxu", "cpu"), no_model)
    with pytest.raises(ValueError, match="deep trainers"):
        TPTrainer(build_family("tabular", "cpu"), no_model)
    # A narrow layer between wide ones: the row layer would meet a
    # replicated activation.
    narrow = DQNAgent(make_env("sokoban"), hidden=(64, 4, 64, 64)).net
    model = AxisGroup(group=None, world_size=2, rank=0, device=cpu, backend="gloo")
    plan = TPPlan(narrow, tp_param_specs(dict(narrow.named_parameters())), model)
    with pytest.raises(ValueError, match="w4: a row layer after a replicated"):
        plan.shard_net(narrow)
