"""The port's expert-parallel demo (``safe_grid_agents_torch/parallel/
ep.py``) on 4 gloo ranks of the CPU, held to the reference's
``tests/test_ep.py`` at its shapes (E 4 experts, 8 tokens a rank, D 16,
H 32, capacity 8).

One module-scoped spawn (``launch.spawn``, a join timeout of ``TIMEOUT``
s) runs ``tools/tp_cases.py::demo_ep`` on JAX-initialised parameters and
inputs: the layer's output and gradients are held to both the JAX
``dense_moe_apply`` and the JAX ``ep_moe_apply`` under ``shard_map`` on 4
of the conftest's CPU devices, at the reference's atol 1e-6; a capacity of
1 drops tokens to the residual path; the expert weights and their
gradients stay one expert a rank; a training run learns.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.parallel import ep as jep  # noqa: E402
from safe_grid_agents_torch.parallel import ep, launch  # noqa: E402
from safe_grid_agents_torch.tools import tp_cases  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 120  # seconds for the spawn of 4 ranks
E, B_LOCAL, D, H = 4, 8, 16, 32
CAP = B_LOCAL  # capacity >= local batch: nothing drops, exact against dense
STEPS, LR = 41, 0.05
NAMES = ("router", "w_in", "w_out")


@pytest.fixture(scope="module")
def world():
    params = jep.init_moe_params(jax.random.PRNGKey(0), E, D, H)
    xs = jax.random.normal(jax.random.PRNGKey(1), (E, B_LOCAL, D))
    t = jax.random.normal(jax.random.PRNGKey(2), xs.shape)
    mesh = jep.make_ep_mesh(E)
    placed = jep.place_ep(mesh, params)

    def loss_ep(p):
        return jnp.mean(jnp.square(jep.ep_moe_apply(mesh, p, xs, CAP) - t))

    def loss_dense(p):
        return jnp.mean(jnp.square(jep.dense_moe_apply(p, xs.reshape(-1, D))
                                   - t.reshape(-1, D)))

    want = {
        "dense": jep.dense_moe_apply(params, xs.reshape(-1, D)).reshape(xs.shape),
        "ep": jax.jit(lambda p, x: jep.ep_moe_apply(mesh, p, x, CAP))(placed, xs),
        "g_dense": jax.grad(loss_dense)(params),
        "g_ep": jax.jit(jax.grad(loss_ep))(placed),
    }
    np_ = {k: jax.tree.map(np.asarray, v) for k, v in want.items()}
    case = {"params": jax.tree.map(np.asarray, params), "xs": np.asarray(xs),
            "targets": np.asarray(t),
            "train_targets": np.asarray(jax.random.normal(jax.random.PRNGKey(3), xs.shape)),
            "capacity": CAP, "steps": STEPS, "lr": LR}
    ranks = launch.spawn(tp_cases.demo_jobs, E, ({"ep": case},), timeout=TIMEOUT)
    return case, np_, sorted((r["ep"] for r in ranks), key=lambda r: r["expert"])


def test_routing_is_nontrivial(world):
    case, _, _ = world
    e = np.argmax(case["xs"].reshape(-1, D) @ case["params"]["router"], -1)
    assert len(np.unique(e)) > 1, "degenerate router: all tokens one expert"


def test_port_dense_matches_the_reference(world):
    case, want, _ = world
    got = ep.dense_moe_apply({k: torch.from_numpy(v.copy()) for k, v in case["params"].items()},
                             torch.from_numpy(case["xs"].reshape(-1, D).copy()))
    np.testing.assert_allclose(got.numpy().reshape(E, B_LOCAL, D), want["dense"], atol=1e-6)


@pytest.mark.parametrize("ref", ["dense", "ep"])
def test_forward_matches(world, ref):
    _, want, ranks = world
    got = np.concatenate([r["ys"].numpy() for r in ranks])
    np.testing.assert_allclose(got, want[ref], atol=1e-6)


@pytest.mark.parametrize("ref", ["g_dense", "g_ep"])
def test_backward_matches(world, ref):
    _, want, ranks = world
    for r in ranks:
        np.testing.assert_allclose(r["grad_router"].numpy(), want[ref]["router"], atol=1e-6)
        for k in ("w_in", "w_out"):
            e = r["expert"]
            np.testing.assert_allclose(r[f"grad_{k}"].numpy(), want[ref][k][e:e + 1],
                                       atol=1e-6, err_msg=f"expert {e} {k}")


def test_capacity_overflow_falls_back_to_residual(world):
    """Capacity 1: at most one token per (source, expert) pair is processed;
    every dropped token passes through unchanged."""
    case, want, ranks = world
    flat_x = case["xs"].reshape(-1, D)
    flat_y = np.concatenate([r["ys_cap1"].numpy() for r in ranks]).reshape(-1, D)
    passed_through = np.all(np.abs(flat_y - flat_x) < 1e-7, axis=-1)
    assert int(passed_through.sum()) > 0, "capacity-1 dropped nothing?"
    dense = want["dense"].reshape(-1, D)
    processed = ~passed_through
    np.testing.assert_allclose(flat_y[processed], dense[processed], atol=1e-6)


def test_expert_grads_stay_expert_sharded(world):
    _, _, ranks = world
    assert [r["expert"] for r in ranks] == list(range(E))
    for r in ranks:
        assert r["shapes"] == {"router": (D, E), "w_in": (1, D, H), "w_out": (1, H, D)}
        assert tuple(r["grad_w_in"].shape) == (1, D, H)
        assert tuple(r["grad_w_out"].shape) == (1, H, D)


def test_train_step_learns(world):
    _, _, ranks = world
    for r in ranks:
        losses = r["losses"]
        assert losses == ranks[0]["losses"]  # the all-reduced loss
        assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
