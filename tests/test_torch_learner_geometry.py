"""Launch geometry and routes of the two learner kernels, on the CPU.

The CUDA kernels run only on a card; their launch geometry is mirrored in
Python (``ops/dqn_update_kernel.py::geometry`` and ``grid_geometry``,
``ops/ppo_kernel.py::geometry`` and ``wide_geometry``, over
``ops/tile_gemm.py``) so that the wrappers pick a route (``route``) or
refuse shapes before a launch. These tests hold the mirrors to the
kernels' partition and shared-memory budget at the main path's shapes, on
ragged edges and on shapes that do not fit; on a card, ``chip_smoke.py``
and ``tools/ab_learners.py`` hold each mirror against the built kernel's
own computation.
"""
import pytest

from safe_grid_agents_torch.ops import dqn_update_kernel as duk
from safe_grid_agents_torch.ops import ppo_kernel as pk
from safe_grid_agents_torch.ops import tile_gemm as tg
from safe_grid_agents_torch.ops.rollout_kernel import SMEM_CAP

H100_SMS = 132

# (D, H1, H2, A, B) -> (cluster, row tile, shared bytes a block)
B4_CASES = {
    "sokoban": ((144, 128, 128, 4, 128), (8, 128, 198720)),
    "whisky": ((128, 128, 128, 4, 128), (8, 128, 185408)),
    "wide": ((144, 128, 128, 4, 512), (16, 128, 212288)),
    "ragged": ((144, 100, 60, 4, 100), (8, 104, 151408)),
    "ragged_wide": ((144, 100, 60, 4, 600), (16, 128, 199328)),
}


@pytest.mark.parametrize("name", sorted(B4_CASES))
def test_dqn_update_geometry_at_main_path_shapes(name):
    shape, (cluster, row_tile, smem) = B4_CASES[name]
    geo = duk.geometry(*shape)
    assert (geo.cluster, geo.row_tile, geo.smem_bytes) == (cluster, row_tile, smem)
    assert geo.smem_bytes <= SMEM_CAP


@pytest.mark.parametrize("name", sorted(B4_CASES))
@pytest.mark.parametrize("cluster", [8, 16])
def test_dqn_update_slices_partition_each_layer(name, cluster):
    D, H1, H2, A, B = B4_CASES[name][0]
    geo = duk.make_geometry(D, H1, H2, A, B, cluster, 8)
    for layer, H in ((0, H1), (1, H2)):
        units = []
        for rank in range(geo.cluster):
            first, count = geo.owned(rank, H1, H2)[layer]
            assert 0 <= count <= (geo.c1, geo.c2)[layer]
            units.extend(range(first, first + count))
        assert units == list(range(H))  # disjoint, in rank order, complete


def test_dqn_update_ragged_edges():
    """100 × 60 at B = 600 needs 16 blocks: 7 and 4 units a block, the last
    ones short or empty; at B = 100 it runs on 8 with a short last block."""
    geo = duk.geometry(144, 100, 60, 4, 600)
    assert (geo.cluster, geo.c1, geo.c2) == (16, 7, 4)
    assert geo.owned(14, 100, 60) == ((98, 2), (56, 4))
    assert geo.owned(15, 100, 60) == ((100, 0), (60, 0))
    assert geo.row_tile == 128 and 600 % geo.row_tile == 88  # a short last row tile
    small = duk.geometry(144, 100, 60, 4, 100)
    assert (small.cluster, small.c1, small.c2) == (8, 13, 8)
    assert small.owned(7, 100, 60) == ((91, 9), (56, 4))
    assert small.row_tile == 104  # B rounded up to a multiple of 8


def test_dqn_update_geometry_prefers_cluster_8_then_shrinks_the_tile():
    geo = duk.geometry(144, 128, 128, 4, 256)
    assert (geo.cluster, geo.row_tile) == (8, 64)
    assert duk.geometry(144, 128, 128, 4, 64).row_tile == 64
    wide = duk.geometry(144, 128, 128, 4, 512)  # no 64-row tile fits on 8: 16 blocks
    assert (wide.cluster, wide.row_tile) == (16, 128)
    assert duk.make_geometry(144, 128, 128, 4, 512, 8, 8).smem_bytes <= SMEM_CAP
    small = duk.geometry(16, 32, 32, 2, 40)
    assert (small.cluster, small.row_tile) == (8, 40)


@pytest.mark.parametrize("shape", [
    (144, 128, 128, 4, 4096),      # the batch's activations do not fit
    (4096, 1024, 1024, 4, 128),    # the parameter slices do not fit
    (144, 512, 512, 4, 128),       # sokoban's table net at --n-hidden 512
    (144, 128, 128, 4, 2048),      # sokoban's batch at 2048
])
def test_dqn_update_geometry_refuses(shape):
    with pytest.raises(ValueError, match="shared memory"):
        duk.geometry(*shape)


# (S, D, H1, H2, A, B) -> (tiles, tiles per block, grid, gfold in smem, smem bytes)
B6_CASES = {
    "island": ((72, 288, 128, 128, 4, 16384), (256, 2, 128, True, 186064)),
    "absent": ((98, 245, 128, 128, 4, 8192), (128, 1, 128, True, 199376)),
    "ragged": ((72, 288, 128, 128, 4, 16700), (261, 2, 131, True, 186064)),
    "wide_table": ((600, 288, 128, 128, 4, 16384), (256, 2, 128, False, 149200)),
}


@pytest.mark.parametrize("name", sorted(B6_CASES))
def test_ppo_optimize_geometry_at_main_path_shapes(name):
    (S, D, H1, H2, A, B), want = B6_CASES[name]
    geo = pk.geometry(S, D, H1, H2, A, 0, B, H100_SMS)
    assert (geo.tiles, geo.tiles_per_block, geo.grid, geo.gf_in_smem, geo.smem_bytes) == want
    assert geo.smem_bytes <= SMEM_CAP and geo.grid <= H100_SMS
    assert geo.record_floats == S * H1 + H1 * H2 + H2 * (A + 2) + A + H1 + 2


@pytest.mark.parametrize("name", sorted(B6_CASES))
@pytest.mark.parametrize("n_sm", [1, 7, 132])
def test_ppo_optimize_stripes_partition_the_rows(name, n_sm):
    (S, D, H1, H2, A, B), _ = B6_CASES[name]
    geo = pk.geometry(S, D, H1, H2, A, 0, B, n_sm)
    assert geo.grid <= n_sm
    rows, at = 0, 0
    for block in range(geo.grid):
        row0, row1 = geo.stripe(block, B)
        assert row0 == at and 0 < row1 - row0 <= geo.tiles_per_block * pk.ROW_TILE
        at, rows = row1, rows + row1 - row0
    assert at == B and rows == B  # disjoint, in block order, every row once


def test_ppo_optimize_ragged_last_stripe():
    geo = pk.geometry(72, 288, 128, 128, 4, 0, 16700, H100_SMS)
    assert geo.stripe(geo.grid - 1, 16700) == (16640, 16700)  # one tile of 60 rows


@pytest.mark.parametrize("shape", [
    (72, 288, 256, 128, 4, 1024),   # hidden wider than 128
    (72, 288, 128, 129, 4, 1024),
    (72, 288, 128, 128, 8, 1024),   # more than 7 actions
    (72, 288, 128, 128, 1, 1024),   # fewer than 2
    (72, 288, 128, 128, 4, 0),      # no rows
])
def test_ppo_optimize_geometry_refuses(shape):
    S, D, H1, H2, A, B = shape
    with pytest.raises(ValueError):
        pk.geometry(S, D, H1, H2, A, 0, B, H100_SMS)


# Route choosers: the resident designs (B4's cluster, B6's persistent grad
# kernel) take the main path's shapes; wider nets or batches go to the
# grid-wide routes (B4's grid kernel, B6's wide kernel).
@pytest.mark.parametrize("shape, route", [
    ((144, 320, 320, 4, 128), "cluster"),  # the widest square net a cluster holds at B=128
    ((144, 321, 321, 4, 128), "grid"),
    ((144, 128, 128, 4, 1041), "cluster"),  # the largest batch a cluster holds at width 128
    ((144, 128, 128, 4, 1042), "grid"),
    ((144, 512, 512, 4, 128), "grid"),     # sokoban --n-hidden 512
    ((144, 128, 128, 4, 4096), "grid"),    # sokoban --batch-size 4096
])
def test_dqn_update_route_boundaries(shape, route):
    assert duk.route(*shape) == route
    if route == "cluster":
        assert duk.geometry(*shape).smem_bytes <= SMEM_CAP
    else:
        with pytest.raises(ValueError, match="shared memory"):
            duk.geometry(*shape)


@pytest.mark.parametrize("shape, route", [
    ((72, 288, 128, 128, 7), "persistent"),  # the widest net and most actions it pads
    ((72, 288, 128, 128, 8), "wide"),
    ((72, 288, 129, 128, 4), "wide"),
    ((72, 288, 128, 129, 4), "wide"),
    ((72, 288, 256, 256, 4), "wide"),        # island --n-hidden 256
    ((72, 288, 1813, 1813, 4), "wide"),      # the widest the first wide design took
])
def test_ppo_optimize_route_boundaries(shape, route):
    assert pk.route(*shape) == route
    S, D, H1, H2, A = shape
    if route == "wide":
        geo = pk.wide_geometry(S, D, H1, H2, A, 0, 16384, H100_SMS)
        assert 0 < geo.smem_bytes <= SMEM_CAP
        with pytest.raises(ValueError):
            pk.geometry(S, D, H1, H2, A, 0, 16384, H100_SMS)


# The wide route takes any width whose parameters its 32-bit element counts
# hold (23,023 at D = 288); fewer than two actions neither route takes.
@pytest.mark.parametrize("shape", [(72, 288, 23024, 23024, 4), (72, 288, 128, 128, 1)])
def test_ppo_optimize_route_refuses(shape):
    with pytest.raises(ValueError):
        pk.route(*shape)


# The grid-wide routes (B4's grid kernel, B6's wide kernel): their mirrors
# cut every product into BM × BN tiles and, for the sums over the batch,
# split-K parts of KC rows; each block of the co-resident grid takes items
# in turn. The shapes of the commands that reach them, ragged edges (B =
# 1000, H = 300, absent's odd D = 245), double-Q's third pass, and B6 at
# the widest the first wide design took and at 8 actions.
GRID_SHAPES = {  # (D, H1, H2, A, B, double_q)
    "b4 hidden512": (144, 512, 512, 4, 128, False),
    "b4 batch4096": (144, 128, 128, 4, 4096, False),
    "b4 ragged": (245, 300, 300, 4, 1000, False),
    "b4 double512": (144, 512, 512, 4, 128, True),
}
WIDE_SHAPES = {  # (S, D, H1, H2, A, B)
    "b6 island256": (72, 288, 256, 256, 4, 16384),
    "b6 island1813": (72, 288, 1813, 1813, 4, 16384),
    "b6 ragged": (98, 245, 300, 300, 4, 1000),
    "b6 actions8": (72, 288, 128, 128, 8, 4100),
}
SM_SMEM = 233472  # shared memory an SM holds (228 KB); the driver keeps 1 KB a block


def _mirror(name, n_sm=H100_SMS):
    if name in GRID_SHAPES:
        D, H1, H2, A, B, dq = GRID_SHAPES[name]
        geo = duk.grid_geometry(D, H1, H2, A, B, dq, n_sm)
        return geo, [list(p) for p in geo.phases]
    S, D, H1, H2, A, B = WIDE_SHAPES[name]
    P = D * H1 + H1 + H1 * H2 + H2 + H2 * (A + 1) + A + 1
    geo = pk.wide_geometry(S, D, H1, H2, A, P, B, n_sm)
    return geo, [[j] for j in geo.jobs]


ALL_GRID = sorted(GRID_SHAPES) + sorted(WIDE_SHAPES)


@pytest.mark.parametrize("name", ALL_GRID)
def test_grid_routes_take_the_shapes_no_resident_design_holds(name):
    if name in GRID_SHAPES:
        D, H1, H2, A, B, _ = GRID_SHAPES[name]
        assert duk.route(D, H1, H2, A, B) == "grid"
    else:
        S, D, H1, H2, A, _ = WIDE_SHAPES[name]
        assert pk.route(S, D, H1, H2, A) == "wide"


@pytest.mark.parametrize("name", ALL_GRID)
def test_grid_tiles_partition_every_output_once(name):
    """In each split-K part of each product the tiles cover [0, M) × [0, N)
    exactly once: their row ranges and column ranges are contiguous, and
    every pair of them is one tile."""
    for phase in _mirror(name)[1]:
        for job in phase:
            by_part = {}
            for part, m0, m1, n0, n1, k0, k1 in job.tiles():
                assert 0 <= m0 < m1 <= job.M and 0 <= n0 < n1 <= job.N
                by_part.setdefault(part, []).append((m0, m1, n0, n1))
            assert sorted(by_part) == list(range(job.splits))
            for rects in by_part.values():
                assert len(set(rects)) == len(rects)
                rows, cols = sorted({r[:2] for r in rects}), sorted({r[2:] for r in rects})
                assert rows[0][0] == 0 and rows[-1][1] == job.M
                assert cols[0][0] == 0 and cols[-1][1] == job.N
                assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
                assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
                assert len(rects) == len(rows) * len(cols)


@pytest.mark.parametrize("name", ALL_GRID)
def test_grid_split_k_parts_join_in_order(name):
    """A part covers KC rows of the batch sum, part p the p-th run of them,
    so joining parts 0, 1, ... in order adds the rows in order; products
    that are not batch sums keep their whole K in one part."""
    for phase in _mirror(name)[1]:
        for job in phase:
            ranges = sorted({(part, k0, k1) for part, *_, k0, k1 in job.tiles()})
            assert [p for p, _, _ in ranges] == list(range(job.splits))
            assert ranges[0][1] == 0 and ranges[-1][2] == job.K
            assert all(a[2] == b[1] for a, b in zip(ranges, ranges[1:]))
            if job.splits > 1:
                assert job.splits == tg.parts(job.K) and job.K > tg.KC
                assert all(k1 - k0 == tg.KC for _, k0, k1 in ranges[:-1])


@pytest.mark.parametrize("name", ALL_GRID)
@pytest.mark.parametrize("n_sm", [1, 132])
def test_grid_fits_the_co_resident_limit(name, n_sm):
    """A block's staged chunks fit its shared memory; BLOCKS_PER_SM of them
    fit an SM with the threads an SM runs; every item goes to a block of
    the grid, which is BLOCKS_PER_SM an SM."""
    geo, phases = _mirror(name, n_sm)
    assert geo.smem_bytes == tg.SMEM_BYTES <= SMEM_CAP
    assert tg.BLOCKS_PER_SM * (tg.SMEM_BYTES + 1024) <= SM_SMEM
    assert tg.BLOCKS_PER_SM * tg.THREADS <= 2048
    assert geo.grid == tg.grid(n_sm) == n_sm * tg.BLOCKS_PER_SM
    for phase in phases:
        blocks = [b for b, _, _ in tg.blocks_of(phase, geo.grid)]
        assert len(blocks) == sum(j.items for j in phase)
        assert all(0 <= b < geo.grid for b in blocks)


@pytest.mark.parametrize("name", ALL_GRID)
def test_grid_scratch_holds_every_buffer(name):
    """The scratch the wrapper allocates holds the kernel's buffers back to
    back, each from a 16-byte boundary: activations and derivatives, each
    batch-sum product's parts, the running loss (and B6's Σg² a block)."""
    geo, phases = _mirror(name)
    B = GRID_SHAPES[name][4] if name in GRID_SHAPES else WIDE_SHAPES[name][5]
    parts = [j.splits * j.M * j.N for p in phases for j in p if j.K == B]
    if name in GRID_SHAPES:
        D, H1, H2, A, _, dq = GRID_SHAPES[name]
        R = (3 if dq else 2) * B
        sizes = [R * H1, R * H2, B * A, B, B * H2, B * H1, *parts, 1]
    else:
        S, D, H1, H2, A, _ = WIDE_SHAPES[name]
        P = D * H1 + H1 + H1 * H2 + H2 + H2 * (A + 1) + A + 1
        sizes = [S * H1, B * H1, B * H1, B * H2, B * H2, B * (A + 1), B, P, *parts,
                 1 + geo.grid]
    starts = [0]
    for n in sizes[:-1]:
        starts.append(-(-(starts[-1] + n) // 4) * 4)
    assert all(s % 4 == 0 for s in starts)
    assert geo.scratch_floats == starts[-1] + sizes[-1]
