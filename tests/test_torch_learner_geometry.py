"""Launch geometry and routes of the two learner kernels, on the CPU.

The CUDA kernels run only on a card; their launch geometry is mirrored in
Python (``ops/dqn_update_kernel.py::geometry`` and ``block_layout``,
``ops/ppo_kernel.py::geometry`` and ``wide_geometry``) so that the
wrappers pick a route (``route``) or refuse shapes before a launch. These tests
hold the mirrors to the kernels' partition and shared-memory budget at the
main path's shapes, on ragged edges and on shapes that do not fit; on a
card, ``chip_smoke.py`` and ``tools/ab_learners.py`` hold each mirror
against the built kernel's own computation.
"""
import pytest

from safe_grid_agents_torch.ops import dqn_update_kernel as duk
from safe_grid_agents_torch.ops import ppo_kernel as pk
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
# restored routes (B4's one-block kernel, B6's six-kernel wide design).
@pytest.mark.parametrize("shape, route", [
    ((144, 320, 320, 4, 128), "cluster"),  # the widest square net a cluster holds at B=128
    ((144, 321, 321, 4, 128), "block"),
    ((144, 128, 128, 4, 1041), "cluster"),  # the largest batch a cluster holds at width 128
    ((144, 128, 128, 4, 1042), "block"),
    ((144, 512, 512, 4, 128), "block"),     # sokoban --n-hidden 512
    ((144, 128, 128, 4, 4096), "block"),    # sokoban --batch-size 4096
])
def test_dqn_update_route_boundaries(shape, route):
    assert duk.route(*shape) == route
    if route == "cluster":
        assert duk.geometry(*shape).smem_bytes <= SMEM_CAP
    else:
        with pytest.raises(ValueError, match="shared memory"):
            duk.geometry(*shape)


@pytest.mark.parametrize("B, H, placement", [
    (144, 128, 0),   # the largest batch whose activations fit beside the per-sample arrays
    (145, 128, 1),
    (3058, 128, 1),  # the largest whose per-sample arrays fit alone
    (3059, 128, 2),
    (128, 512, 1),   # sokoban --n-hidden 512
    (4096, 128, 2),  # sokoban --batch-size 4096
])
def test_dqn_update_block_layout_boundaries(B, H, placement):
    got, smem, scratch = duk.block_layout(B, H, H, 4)
    small, big = B * (5 + 3 * 4 + 2), 3 * B * H
    assert got == placement and smem <= SMEM_CAP
    assert (smem, scratch) == {0: (4 * (small + big), 0), 1: (4 * small, big),
                               2: (0, small + big)}[placement]


@pytest.mark.parametrize("shape, route", [
    ((72, 288, 128, 128, 7), "persistent"),  # the widest net and most actions it pads
    ((72, 288, 128, 128, 8), "wide"),
    ((72, 288, 129, 128, 4), "wide"),
    ((72, 288, 128, 129, 4), "wide"),
    ((72, 288, 256, 256, 4), "wide"),        # island --n-hidden 256
    ((72, 288, 1813, 1813, 4), "wide"),      # the widest an 8-row tile holds
])
def test_ppo_optimize_route_boundaries(shape, route):
    assert pk.route(*shape) == route
    S, D, H1, H2, A = shape
    if route == "wide":
        geo = pk.wide_geometry(S, D, H1, H2, A, 0, 16384)
        assert 0 < geo.smem_bytes <= SMEM_CAP
        with pytest.raises(ValueError):
            pk.geometry(S, D, H1, H2, A, 0, 16384, H100_SMS)


@pytest.mark.parametrize("shape", [(72, 288, 1814, 1814, 4), (72, 288, 128, 128, 1)])
def test_ppo_optimize_route_refuses(shape):
    with pytest.raises(ValueError):
        pk.route(*shape)


@pytest.mark.parametrize("H, rows", [(128, 64), (129, 32), (256, 32), (257, 16), (512, 16),
                                     (513, 8), (1024, 8), (1813, 8)])
def test_ppo_wide_row_tile_shrinks_with_the_width(H, rows):
    geo = pk.wide_geometry(72, 288, H, H, 4, 1000, 16384)
    assert geo.rows == rows and geo.blocks == -(-16384 // rows)
    record = 72 * H + H * H + H * 6 + 4 + H + 2
    assert geo.scratch_floats == 2 * 72 * H + 1000 + 4 + geo.blocks * record
