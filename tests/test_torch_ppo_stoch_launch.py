"""B10's launch path on the CPU: the single-buffer output carving.

``ppo_stoch_collect`` hands the kernel one buffer for its 18 outputs
(``carve_outputs``): the nine ``[T, N]`` records, then the lane state and
the four accumulators, all 4-byte words, at the offsets the C entry point
computes. These tests hold the carved views to the dtypes, shapes and
contiguity of the plain version's outputs, and to that layout.
"""
import pytest
import torch

from safe_grid_agents_torch.agents.ppo import PPOAgent
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.vec import VecEnv
from safe_grid_agents_torch.ops import ppo_stoch_collect_kernel as psk
from safe_grid_agents_torch.training import FusedPPOTrainer


@pytest.fixture(scope="module")
def plain_outputs():
    """The plain version's 18 outputs on absent at N = 100, T = 16."""
    cenv = make_env("absent", compiled=True, device="cpu")
    tr = FusedPPOTrainer(PPOAgent(cenv, net="table"), VecEnv(cenv, 100))
    g = torch.Generator().manual_seed(0)
    astate, vstate = tr.init(seed=0, generator=g)
    state = tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                     vstate.ep_hidden, vstate.ep_len))
    u = torch.rand((16, 100), generator=g)
    return psk.ppo_stoch_collect(tr.tables, tr.policy_rows(astate.params), state, u,
                                 *tr.vec.draw_mechanics(g, 16))


@pytest.mark.parametrize("T, N", [(16, 100), (32, 1024), (48, 4096), (16, 1)])
def test_carved_outputs_match_the_plain_outputs(plain_outputs, T, N):
    buf, outs = psk.carve_outputs(T, N, "cpu")
    assert len(outs) == len(plain_outputs) == 18
    assert buf.dtype == torch.int32 and buf.numel() == 9 * (T + 1) * N
    for i, (got, want) in enumerate(zip(outs, plain_outputs)):
        assert got.dtype == want.dtype, i
        assert got.dim() == want.dim() and got.is_contiguous(), i
        assert tuple(got.shape) == ((1, N) if i < 9 else (T, N)), i


# Word offsets of the 18 outputs (in the wrapper's order) in the buffer, as
# ppo_stoch_collect_launch writes them: records by dtype (pre_idx, pre_t,
# action, done, next_idx; logp, value, reward, hidden), then the lanes by
# dtype (idx, t, ep_len; ep_return, ep_hidden, the four accumulators).
LANE_SLOTS = (0, 1, 3, 4, 2, 5, 6, 7, 8)
RECORD_SLOTS = (0, 1, 2, 5, 6, 7, 8, 3, 4)


@pytest.mark.parametrize("T, N", [(16, 100), (32, 1024)])
def test_carving_follows_the_kernel_layout(T, N):
    """Each view starts at the word the kernel writes it to; no two views
    overlap, and together they cover the buffer."""
    buf, outs = psk.carve_outputs(T, N, "cpu")
    base = buf.data_ptr()
    words = [(x.data_ptr() - base) // 4 for x in outs]
    assert words[9:] == [r * T * N for r in RECORD_SLOTS]
    assert words[:9] == [9 * T * N + i * N for i in LANE_SLOTS]
    assert all(x.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
               for x in outs)
    spans = sorted((w, w + x.numel()) for w, x in zip(words, outs))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[0][0] == 0 and spans[-1][1] == buf.numel()


def test_tile_bytes_fit_beside_the_tomato_tables():
    """The stream and record tiles leave tomato's rows and tables in shared
    memory, as they were before the tiles (friend at cap 15 stays in device
    memory, as before)."""
    from safe_grid_agents_torch.ops import stoch_rollout_kernel as srk
    for alias, kw, place in (("tomato", {}, "shared"), ("friend", {"cap": 15}, "global")):
        cenv = make_env(alias, compiled=True, device="cpu", **kw)
        tables = VecEnv(cenv, 4).tables
        S, A = tables.shape
        assert srk.placement(tables, psk.smem_bytes(S, A)) == place
        assert srk.placement(tables, psk.rows_bytes(S, A)) == place
