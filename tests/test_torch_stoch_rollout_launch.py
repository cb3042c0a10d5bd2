"""B7's launch path on the CPU: the placement of the tables beside the
stream tiles, the shared-memory layout and the single-buffer outputs.

The kernel stages the streams an env reads (actions; bits where there is a
reset coin or drying; stumble and rand_a where there is noise) in
double-buffered tiles of 16 steps × 32 lanes, and the tables beside them
where they fit in one block's 227 KB (``smem_bytes``, the mirror of
``layout`` in ``csrc/stoch_rollout_kernel.cu``, held against the built
kernel on the card). These tests hold the mirror and the placement it
gives on every stochastic alias, with the tiles counted: friend's family
at cap 15 keeps its 182 KB of tables in shared memory, at cap 127 in device
memory. ``stoch_rollout`` hands the kernel its 8 outputs as views of one
buffer (``carve_outputs``); the views carry the plain version's dtypes and
shapes, and the pointers it passes (``OUT_WORDS``) land on them.
"""
import pytest
import torch

from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.ops import stoch_rollout_kernel as srk
from safe_grid_agents_torch.ops.rollout_kernel import SMEM_CAP

# alias, compile kwargs, the streams read, the placement.
ALIASES = {
    "absent": ({}, 2, "shared"), "interrupt": ({}, 2, "shared"), "whisky": ({}, 3, "shared"),
    "tomato": ({}, 2, "shared"),
    "friend@15": ({"cap": 15}, 2, "shared"), "foe@15": ({"cap": 15}, 2, "shared"),
    "neutral@15": ({"cap": 15}, 2, "shared"), "friend@127": ({"cap": 127}, 2, "global"),
}


@pytest.fixture(scope="module")
def engines():
    cache = {}

    def get(alias):
        if alias not in cache:
            kw = ALIASES[alias][0]
            cenv = make_env(alias.partition("@")[0], compiled=True, device="cpu", **kw)
            cache[alias] = srk.StochRolloutEngine(cenv, 33)
        return cache[alias]
    return get


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_placement_counts_the_stream_tiles(engines, alias):
    """The tables go to shared memory where they fit beside two buffers of
    the read streams' tiles (4 KB a stream), each array at a 16-byte
    boundary; tables that do not fit stay in device memory, and the tiles
    alone then take the shared memory."""
    tables = engines(alias).tables
    _, n_streams, place = ALIASES[alias]
    tiles = 2 * n_streams * 4 * 32 * 16
    assert srk.stream_count(tables) == n_streams
    assert srk.smem_bytes(tables, tables_in_smem=False) == tiles
    staged = srk.smem_bytes(tables)
    assert tiles + srk.table_bytes(tables) <= staged <= tiles + srk.table_bytes(tables) + 7 * 15
    assert staged % 16 == 0
    assert srk.rollout_placement(tables) == place
    assert (staged <= SMEM_CAP) == (place == "shared")


def test_friend_at_cap_15_fits_only_with_room_for_the_tiles(engines):
    """Friend at cap 15: 182 KB of tables and 8 KB of tiles in 227 KB; the
    placement B8-B10 ask for (``placement`` with their own extra bytes) is
    unchanged."""
    tables = engines("friend@15").tables
    assert 182_000 < srk.table_bytes(tables) < 183_000
    assert srk.smem_bytes(tables) - srk.smem_bytes(tables, tables_in_smem=False) < 183_000
    assert SMEM_CAP - srk.smem_bytes(tables) > 40_000
    assert srk.placement(tables) == "shared"


@pytest.mark.parametrize("alias", ["absent", "whisky", "tomato", "friend@127"])
@pytest.mark.parametrize("T", [17, 0])
def test_carved_outputs_carry_the_plain_outputs(engines, alias, T):
    """Views of a buffer written at the words the launch's pointers point
    to (``OUT_WORDS``, in the launch's order of the 8 outputs, which is the
    wrapper's) have the plain version's dtypes, shapes and values."""
    eng = engines(alias)
    g = torch.Generator().manual_seed(0)
    plain = eng.run_streams(eng.reset(g), *eng.draw_streams(g, T))
    N = eng.n_envs
    buf, outs = srk.carve_outputs(N, "cpu")
    assert buf.dtype == torch.int32 and buf.numel() == 8 * N
    for w, x in zip(srk.OUT_WORDS, plain):
        buf[w * N:(w + 1) * N] = x.reshape(-1).view(torch.int32)
    assert len(outs) == len(plain) == 8
    for i, (got, want) in enumerate(zip(outs, plain)):
        assert got.dtype == want.dtype and got.shape == want.shape == (1, N), i
        assert got.is_contiguous(), i
        assert got.data_ptr() == buf.data_ptr() + 4 * srk.OUT_WORDS[i] * N, i
        assert torch.equal(got, want), i


def test_wrapper_refuses_devices_it_has_no_kernel_for(engines):
    eng = engines("absent")
    g = torch.Generator().manual_seed(0)
    state = tuple(x.to("meta") for x in eng.reset(g))
    streams = tuple(x.to("meta") for x in eng.draw_streams(g, 16))
    tables = eng.tables
    meta = type(tables)(**{k: (v.to("meta") if torch.is_tensor(v) else v)
                           for k, v in vars(tables).items()})
    with pytest.raises(ValueError, match="unsupported device"):
        srk.stoch_rollout(meta, state, *streams)
    with pytest.raises(ValueError, match="actions"):
        srk.stoch_rollout(tables, eng.reset(g), *(x[0] for x in eng.draw_streams(g, 4)))
