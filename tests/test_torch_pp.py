"""The port's pipeline-parallel demo (``safe_grid_agents_torch/parallel/
pp.py``) on 4 gloo ranks of the CPU, held to the reference's
``tests/test_pp.py`` at its shapes (S 4 stages, L 2 layers a stage, D 16,
M 6 microbatches of 4).

One module-scoped spawn (``launch.spawn``, a join timeout of ``TIMEOUT``
s) runs ``tools/tp_cases.py::demo_pp`` on JAX-initialised parameters and
inputs: the GPipe forward is held to the port's ``sequential_apply`` at
the reference's atol 1e-6 (``tests/test_pp.py`` holds the two programs of
one package to each other), and it and each stage's gradient are held to
both the JAX ``sequential_apply`` and the JAX ``pipeline_apply`` under
``shard_map`` on 4 of the conftest's CPU devices; the parameters and
gradients stay one stage a rank; a training run learns.

Across the two packages the gradients meet the reference's atol 1e-6; the
forward is held to ``CROSS_ATOL`` = 2e-6: eight residual layers of float32
16-term products summed in another order by XLA and by PyTorch's CPU BLAS
put the two outputs up to 1.6e-6 apart on these inputs (each is within
1.4e-6 of a float64 evaluation), past 1e-6 on values of up to 3.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.parallel import pp as jpp  # noqa: E402
from safe_grid_agents_torch.parallel import launch, pp  # noqa: E402
from safe_grid_agents_torch.tools import tp_cases  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 120  # seconds for the spawn of 4 ranks
S, L, D, M, MB = 4, 2, 16, 6, 4
STEPS, LR = 31, 0.05
CROSS_ATOL = 2e-6  # the forward across XLA and PyTorch (module doc)


def _mse(ys, t):
    return jnp.mean(jnp.square(ys - t))


@pytest.fixture(scope="module")
def world():
    params = jpp.init_pp_params(jax.random.PRNGKey(0), S, D, L)
    xs = jax.random.normal(jax.random.PRNGKey(1), (M, MB, D))
    t = jax.random.normal(jax.random.PRNGKey(2), xs.shape)
    mesh = jpp.make_pp_mesh(S)
    placed = jpp.place_pp(mesh, params)
    want = {
        "seq": jpp.sequential_apply(params, xs),
        "pp": jax.jit(lambda p, x: jpp.pipeline_apply(mesh, p, x))(placed, xs),
        "g_seq": jax.grad(lambda p: _mse(jpp.sequential_apply(p, xs), t))(params),
        "g_pp": jax.jit(jax.grad(lambda p: _mse(jpp.pipeline_apply(mesh, p, xs), t)))(placed),
    }
    np_ = {k: jax.tree.map(np.asarray, v) for k, v in want.items()}
    case = {"params": jax.tree.map(np.asarray, params), "xs": np.asarray(xs),
            "targets": np.asarray(t),
            "train_targets": np.asarray(jax.random.normal(jax.random.PRNGKey(3), xs.shape)),
            "steps": STEPS, "lr": LR}
    ranks = launch.spawn(tp_cases.demo_jobs, S, ({"pp": case},), timeout=TIMEOUT)
    return case, np_, [r["pp"] for r in ranks]


def _port_sequential(case):
    return pp.sequential_apply({k: torch.from_numpy(v.copy()) for k, v in case["params"].items()},
                               torch.from_numpy(case["xs"].copy()))


def test_port_sequential_matches_the_reference(world):
    case, want, _ = world
    np.testing.assert_allclose(_port_sequential(case).numpy(), want["seq"], atol=CROSS_ATOL)


@pytest.mark.parametrize("ref", ["port seq", "seq", "pp"])
def test_forward_matches(world, ref):
    case, want, ranks = world
    ref_ys, atol = ((_port_sequential(case).numpy(), 1e-6) if ref == "port seq"
                    else (want[ref], CROSS_ATOL))
    for r in ranks:  # every stage holds the replicated output
        np.testing.assert_allclose(r["ys"].numpy(), ref_ys, atol=atol)


@pytest.mark.parametrize("ref", ["g_seq", "g_pp"])
def test_backward_matches(world, ref):
    _, want, ranks = world
    for r in ranks:
        s = r["stage"]
        for k in ("w", "b"):
            np.testing.assert_allclose(r[k].numpy(), want[ref][k][s:s + 1], atol=1e-6,
                                       err_msg=f"stage {s} {k}")


def test_params_and_grads_stay_stage_sharded(world):
    _, _, ranks = world
    assert sorted(r["stage"] for r in ranks) == list(range(S))
    for r in ranks:
        assert r["shapes"] == {"w": (1, L, D, D), "b": (1, L, D)}
        assert tuple(r["w"].shape) == (1, L, D, D) and tuple(r["b"].shape) == (1, L, D)


def test_train_step_learns(world):
    _, _, ranks = world
    for r in ranks:
        losses = r["losses"]
        assert losses == ranks[0]["losses"]  # one loss, replicated
        assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
