"""The port's ring-attention demo (``safe_grid_agents_torch/parallel/
sp.py``) on 4 gloo ranks of the CPU, held to the reference's
``tests/test_sp.py`` at its shapes (S 4 shards, L 32, D 16).

One module-scoped spawn (``launch.spawn``, a join timeout of ``TIMEOUT``
s) runs ``tools/tp_cases.py::demo_sp`` on the JAX draws: each rank's
output block and gradients are held to both the JAX ``full_attention`` and
the JAX ``ring_attention`` under ``shard_map`` on 4 of the conftest's CPU
devices, at the reference's atol 1e-5; the output stays one block a rank;
no tensor of the forward or backward is ``[L, L]``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.parallel import sp as jsp  # noqa: E402
from safe_grid_agents_torch.parallel import launch, sp  # noqa: E402
from safe_grid_agents_torch.tools import tp_cases  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 120  # seconds for the spawn of 4 ranks
S, L, D = 4, 32, 16
BLK = L // S


@pytest.fixture(scope="module")
def world():
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q, k, v = (jax.random.normal(kk, (L, D)) for kk in ks)
    t = jax.random.normal(jax.random.PRNGKey(4), (L, D))
    mesh = jsp.make_sp_mesh(S)
    pq, pk, pv = jsp.place_sp(mesh, q, k, v)

    def loss_ring(q, k, v):
        return jnp.mean(jnp.square(jsp.ring_attention(mesh, q, k, v) - t))

    def loss_full(q, k, v):
        return jnp.mean(jnp.square(jsp.full_attention(q, k, v) - t))

    want = {
        "full": jsp.full_attention(q, k, v),
        "ring": jax.jit(lambda q, k, v: jsp.ring_attention(mesh, q, k, v))(pq, pk, pv),
        "g_full": jax.grad(loss_full, argnums=(0, 1, 2))(q, k, v),
        "g_ring": jax.jit(jax.grad(loss_ring, argnums=(0, 1, 2)))(pq, pk, pv),
    }
    np_ = {key: jax.tree.map(np.asarray, val) for key, val in want.items()}
    case = {"q": np.asarray(q), "k": np.asarray(k), "v": np.asarray(v),
            "targets": np.asarray(t), "shards": S}
    ranks = launch.spawn(tp_cases.demo_jobs, S, ({"sp": case},), timeout=TIMEOUT)
    return case, np_, sorted((r["sp"] for r in ranks), key=lambda r: r["shard"])


def test_port_full_attention_matches_the_reference(world):
    case, want, _ = world
    got = sp.full_attention(*(torch.from_numpy(case[n].copy()) for n in "qkv"))
    np.testing.assert_allclose(got.numpy(), want["full"], atol=1e-5)


@pytest.mark.parametrize("ref", ["full", "ring"])
def test_forward_matches(world, ref):
    _, want, ranks = world
    got = np.concatenate([r["out"].numpy() for r in ranks])
    np.testing.assert_allclose(got, want[ref], atol=1e-5)


def test_output_stays_sequence_sharded(world):
    _, _, ranks = world
    assert [r["shard"] for r in ranks] == list(range(S))
    assert all(r["block"] == (BLK, D) for r in ranks)


@pytest.mark.parametrize("ref", ["g_full", "g_ring"])
def test_backward_matches(world, ref):
    _, want, ranks = world
    for i, name in enumerate("qkv"):
        got = np.concatenate([r[f"grad_{name}"].numpy() for r in ranks])
        np.testing.assert_allclose(got, want[ref][i], atol=1e-5, err_msg=name)


def test_no_full_score_matrix_needed(world):
    """Every tensor the forward and backward made is a block: ``[L/S,
    L/S]`` scores, ``[L/S, d]`` rows, ``[L/S, 2d]`` travelling keys and
    values; none is ``[L, L]`` or as large as the whole sequence's keys."""
    _, _, ranks = world
    for r in ranks:
        shapes = set(map(tuple, r["shapes"]))
        assert (BLK, BLK) in shapes and (L, L) not in shapes
        assert max(int(np.prod(s)) for s in shapes) < L * D, sorted(shapes)
