"""B11's arithmetic and launch geometry on the CPU.

The kernel (``csrc/fused_mlp.cu``) computes its three products on the
tensor cores with TF32 operands, each fp32 operand split into ``hi`` (x
rounded to TF32, to nearest with ties away from zero) and ``lo`` (x − hi
truncated to TF32), and accumulates lo·hi + hi·lo + hi·hi in fp32, one
8-deep ``mma.sync`` step at a time (3xTF32). The card cannot be asked here,
so these tests model that arithmetic in numpy on the fp32 bits and hold the
model to ``fused_mlp_reference`` within the forward's atol 1e-5; a model of
single TF32 (hi·hi alone) misses it, which is why the kernel splits. They
also mirror the kernel's row-tile choice (``fused_mlp.geometry``), which
the card legs hold against the built kernel's.
"""
import numpy as np
import pytest
import torch

from safe_grid_agents_torch.ops import fused_mlp as fm
from safe_grid_agents_torch.tools import learner_cases as lc

F32, F64 = np.float32, np.float64
MASK = np.uint32(0xFFFFE000)  # TF32 keeps the sign, the exponent and 10 mantissa bits
NAMES = ("w1", "b1", "w2", "b2", "wh", "bh")


def tf32_nearest(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to TF32, to nearest with ties away from zero (the
    kernel's ``split``: add half of the dropped 13 bits, then drop them)."""
    return ((a.view(np.uint32) + np.uint32(0x1000)) & MASK).view(F32)


def tf32_truncate(a: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) & MASK).view(F32)


def split(a: np.ndarray):
    hi = tf32_nearest(a)
    return hi, tf32_truncate((a - hi).astype(F32))


def product(a: np.ndarray, b: np.ndarray, three: bool = True) -> np.ndarray:
    """``a @ b`` as the kernel sums it: per 8-deep k-step, each TF32 product
    (exact in fp32) is added to an fp32 accumulator, lo·hi, hi·lo, then
    hi·hi (``three``), or hi·hi alone (single TF32)."""
    (ahi, alo), (bhi, blo) = split(a), split(b)
    pairs = ((alo, bhi), (ahi, blo), (ahi, bhi)) if three else ((ahi, bhi),)
    acc = np.zeros((a.shape[0], b.shape[1]), F32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in pairs:
            acc = (acc.astype(F64) + x[:, k0:k0 + 8].astype(F64) @ y[k0:k0 + 8].astype(F64)
                   ).astype(F32)
    return acc


def forward_model(x: np.ndarray, p: dict, three: bool = True):
    """``(out, h1, h2)`` of the kernel's forward: the first D rows of w1,
    bias added in fp32 after each product, tanh on the hidden layers."""
    D = x.shape[1]
    h1 = np.tanh(product(x, p["w1"][:D], three) + p["b1"]).astype(F32)
    h2 = np.tanh(product(h1, p["w2"], three) + p["b2"]).astype(F32)
    return (product(h2, p["wh"], three) + p["bh"]).astype(F32), h1, h2


def _case(D: int, B: int, seed: int):
    """Seeded inputs: the net's flax initialisation plus small noise (so the
    biases are not zero), and B rows of observation planes (each cell on
    with probability 0.2)."""
    rng = np.random.default_rng(seed)
    net = fm.PallasActorCriticMLP(D, 4)
    p = {k: v.numpy() for k, v in net.init_params(torch.Generator().manual_seed(seed),
                                                   "cpu").items()}
    p = {k: (v + 0.01 * rng.standard_normal(v.shape)).astype(F32) for k, v in p.items()}
    x = (rng.random((B, D)) < 0.2).astype(F32)
    ref = fm.fused_mlp_reference(torch.from_numpy(x), *(torch.from_numpy(p[k]) for k in NAMES))
    return x, p, [t.numpy() for t in ref]


# Island's observation (4 planes of 8 × 9) and absent's (245, odd: the last
# k-tile is partial and x's rows are not 16-byte multiples).
@pytest.mark.parametrize("D", [288, 245])
def test_three_tf32_products_stay_within_the_forward_tolerance(D):
    x, p, ref = _case(D, 48, seed=D)
    for got, want, name in zip(forward_model(x, p), ref, ("out", "h1", "h2")):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("D", [288, 245])
def test_single_tf32_misses_the_forward_tolerance(D):
    """hi·hi alone keeps ~3 decimal digits: the head is off by far more than
    1e-5, so the split is needed."""
    x, p, ref = _case(D, 48, seed=D)
    err = np.abs(forward_model(x, p, three=False)[0] - ref[0]).max()
    assert err > 1e-5, err
    err3 = np.abs(forward_model(x, p)[0] - ref[0]).max()
    assert err3 < err / 20, (err3, err)


def test_split_is_exact_where_it_must_be():
    """hi + lo reproduces x to within TF32's precision of lo (2^-22 of x),
    hi and lo are TF32 values (their low 13 bits are zero), and ties round
    away from zero."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(10_000) * 10.0 ** rng.integers(-6, 6, 10_000)).astype(F32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & ~MASK).any() and not (lo.view(np.uint32) & ~MASK).any()
    rel = np.abs((hi.astype(F64) + lo.astype(F64)) - x.astype(F64)) / np.abs(x.astype(F64))
    assert rel.max() < 2.0 ** -21, rel.max()
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], F32)  # exactly half a TF32 ulp
    np.testing.assert_array_equal(tf32_nearest(tie), np.array([1 + 2 ** -10, -(1 + 2 ** -10)],
                                                               F32))


# Rows -> (row tile, tiles, grid) on a card of 132 SMs (the H100 SXM): the
# collect's 1024 rows spread over 64 SMs in 16-row tiles, the update's
# 16,384 rows run 64-row tiles on every SM.
GEOMETRIES = {1: (16, 1, 1), 33: (16, 3, 3), 1024: (16, 64, 64), 4096: (32, 128, 128),
              8192: (64, 128, 128), 16384: (64, 256, 132)}


@pytest.mark.parametrize("B", sorted(GEOMETRIES))
def test_geometry_mirrors_the_kernel_row_tile_choice(B):
    geo = fm.geometry(B, 132)
    assert (geo.rows, geo.tiles, geo.grid) == GEOMETRIES[B]
    # w2 and wh, the ring of w1 and x k-tiles (16 deep × 4 at 64 rows, 32 deep
    # × 3 at 32 rows, × 4 at 16), the activation tile, with the kernel's
    # padded strides; one block an SM.
    depth, stages = {64: (16, 4), 32: (32, 3), 16: (32, 4)}[geo.rows]
    floats = (2 * 128 * 136 + stages * depth * 136 + stages * geo.rows * (depth + 4)
              + geo.rows * 132)
    assert geo.smem_bytes == 4 * floats <= 232448


@pytest.mark.parametrize("n_sm", [1, 8, 66, 132])
def test_geometry_covers_every_row_once(n_sm):
    """The tiles cover B rows exactly once (the last tile may be partial),
    and the persistent grid never exceeds the SMs or the tiles; the largest
    tile is taken only where it leaves more than n_sm / 2 tiles."""
    for B in (1, 15, 16, 17, 33, 1000, 1024, 4095, 16384, 16700):
        geo = fm.geometry(B, n_sm)
        assert geo.rows in fm.ROW_TILES
        assert (geo.tiles - 1) * geo.rows < B <= geo.tiles * geo.rows
        assert geo.grid == min(geo.tiles, n_sm)
        bigger = [r for r in fm.ROW_TILES if r > geo.rows]
        assert all(2 * -(-B // r) <= n_sm for r in bigger), (B, n_sm, geo)


@pytest.mark.parametrize("name", sorted(lc.B11_CASES))
def test_b11_cases_have_their_shapes(name):
    B = lc.B11_CASES[name]
    x, w1, b1, w2, b2, wh, bh = lc.fused_mlp_case(B, torch.device("cpu"),
                                                  torch.Generator().manual_seed(0))
    assert x.shape == (B, 288) and bool(((x == 0) | (x == 1)).all())
    assert w1.shape == (384, 128) and w2.shape == wh.shape == (128, 128)
    assert b1.shape == b2.shape == bh.shape == (1, 128)

