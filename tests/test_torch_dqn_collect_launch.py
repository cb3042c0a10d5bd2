"""B3's launch path on the CPU: the single-buffer outputs, the shared-memory
layout and the checks.

``dqn_collect`` hands the kernel one buffer for its 16 outputs
(``carve_outputs``): the int64 step in a 16-byte head, the six ``[T, N]``
records, then the lane state and the four accumulators, all 4-byte words,
at the offsets ``dqn_collect_launch`` writes them to. These tests write the
plain version's outputs into a buffer at those offsets and read them back
through the carved views, hold the alignments the kernel's stores need,
hold the kernel's shared-memory layout (mirrored by ``smem_bytes``) to the
card's cap, and check that every wrong input still raises: the tables when
they are built (``Tables``), the rest on each call.
"""
import dataclasses
from pathlib import Path

import pytest
import torch

from safe_grid_agents_torch.agents.dqn import DQNAgent
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.vec import VecEnv
from safe_grid_agents_torch.ops import dqn_kernel as dk
from safe_grid_agents_torch.ops.rollout_kernel import SMEM_CAP, Tables
from safe_grid_agents_torch.tools import ab_learners as abl
from safe_grid_agents_torch.tools import learner_cases as lc
from safe_grid_agents_torch.training import FusedDQNTrainer

CPU = torch.device("cpu")

# Record r of the wrapper's order (pre_idx, pre_t, action, reward, next_idx,
# done) sits at record slot RECORD_SLOTS[r] of the buffer (the int32
# records first, then reward); lane output i (idx, t, ep_return, ep_hidden,
# ep_len, then after the step episodes, return, hidden, length) at lane
# slot LANE_SLOTS[i] after the records.
RECORD_SLOTS = (0, 1, 2, 5, 3, 4)
LANE_SLOTS = (0, 1, 3, 4, 2, 5, 6, 7, 8)


def _inputs(alias, N, T, seed=0, cheat=False):
    cenv = make_env(alias, compiled=True, device="cpu")
    tr = FusedDQNTrainer(DQNAgent(cenv, epsilon_anneal_steps=60_000), VecEnv(cenv, N),
                         cheat=cheat)
    g = torch.Generator().manual_seed(seed)
    astate, state = tr.init(generator=g)
    greedy = torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g)
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g)
    u = torch.rand((T, N), generator=g)
    step0 = torch.tensor([20_000], dtype=torch.int64)
    return tr.tables, tr.hyper, greedy, state, step0, rand_a, u


@pytest.fixture(scope="module")
def sokoban():
    return _inputs("sokoban", 33, 17)


def _kernel_write(outs, T, N) -> torch.Tensor:
    """A buffer filled as ``dqn_collect_launch`` fills it from the outputs
    ``outs`` (in the wrapper's order)."""
    buf = torch.zeros(dk.HEAD_WORDS + 6 * T * N + 9 * N, dtype=torch.int32)
    buf[:2] = outs[5].view(torch.int32)
    for r, slot in enumerate(RECORD_SLOTS):
        at = dk.HEAD_WORDS + slot * T * N
        buf[at:at + T * N] = outs[10 + r].reshape(-1).view(torch.int32)
    lanes = outs[:5] + outs[6:10]
    for i, slot in enumerate(LANE_SLOTS):
        at = dk.HEAD_WORDS + 6 * T * N + slot * N
        buf[at:at + N] = lanes[i].reshape(-1).view(torch.int32)
    return buf


@pytest.mark.parametrize("T, N, cheat", [(17, 33, False), (32, 128, True), (0, 5, False)])
def test_carved_outputs_carry_the_plain_outputs(T, N, cheat):
    """Views of a buffer written at the kernel's offsets have the plain
    version's dtypes, shapes and values (a partial tile and warp, the DQN
    command's chunk under ``--cheat``, and no steps at all)."""
    plain = dk.dqn_collect(*_inputs("sokoban", N, T, cheat=cheat))
    written = _kernel_write(plain, T, N)
    buf, outs = dk.carve_outputs(T, N, "cpu")
    assert buf.dtype == torch.int32 and buf.numel() == written.numel()
    buf.copy_(written)
    assert len(outs) == len(plain) == 16
    for i, (got, want) in enumerate(zip(outs, plain)):
        assert got.dtype == want.dtype and got.shape == want.shape, i
        assert got.is_contiguous(), i
        assert torch.equal(got, want), i


@pytest.mark.parametrize("T, N", [(17, 33), (32, 128), (4096, 4096), (0, 1)])
def test_carved_views_tile_the_buffer(T, N):
    """No two views overlap, and with the head's two pad words they cover
    the buffer."""
    buf, outs = dk.carve_outputs(T, N, torch.device("meta"))
    words = [x.storage_offset() * x.element_size() // 4 for x in outs]
    spans = sorted((w, w + x.numel() * x.element_size() // 4) for w, x in zip(words, outs))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[0] == (0, 2) and spans[1][0] == dk.HEAD_WORDS
    assert spans[-1][1] == buf.numel()
    assert sum(b - a for a, b in spans) == buf.numel() - 2


# B3's shapes, then B9's (which carves its outputs alike): its tiles'
# edges, the command's chunk and the full width.
@pytest.mark.parametrize("T, N", [(17, 33), (32, 128), (16, 4096), (16, 1), (32, 33),
                                  (1024, 128), (4096, 4096)])
def test_step_and_records_are_aligned_for_the_kernel_stores(T, N):
    """The int64 step is 8-byte aligned; every record row starts 16-byte
    aligned when N is a multiple of 4 (the kernels' 16-byte stores need
    it), and the first record always does."""
    buf, outs = dk.carve_outputs(T, N, torch.device("meta") if T * N > 1 << 20 else "cpu")
    base = buf.data_ptr()
    assert base % 16 == 0 and (outs[5].data_ptr() - base) % 8 == 0
    offsets = [x.data_ptr() - base for x in outs[10:]]
    assert min(offsets) == 16
    if N % 4 == 0:
        assert all((o + 4 * N * row) % 16 == 0 for o in offsets for row in (0, 1, T - 1))


@pytest.mark.parametrize("alias", ["shift", "island", "sokoban", "tomato"])
def test_tiles_fit_beside_the_tables(alias):
    """The draw and record tiles (20 KB) fit beside the tables and the
    greedy row in one block's shared memory: sokoban's 1296 states take 73
    KB of them, the largest alias the deterministic DQN path runs, and
    tomato's 1344 states would take 75 KB."""
    S, A = VecEnv(make_env(alias, compiled=True, device="cpu"), 1).tables.shape
    need = dk.smem_bytes(S, A)
    assert dk.TILE_BYTES == 4 * 32 * 16 * (2 * 2 + 6)
    tables_and_row = 13 * S * A + 4 * S
    assert tables_and_row + dk.TILE_BYTES <= need <= tables_and_row + dk.TILE_BYTES + 5 * 15
    assert need <= SMEM_CAP


def test_tables_are_checked_when_built(sokoban):
    tables = sokoban[0]
    for field, bad in (("next", tables.next.to(torch.int64)),
                       ("reward", tables.reward.to(torch.float64)),
                       ("hidden", tables.hidden[:, :2]),
                       ("done", tables.done.t()),
                       ("next", tables.next.reshape(-1))):
        with pytest.raises(ValueError, match="tables.next|tables." + field):
            dataclasses.replace(tables, **{field: bad})


def _tables_on(tables, device):
    return Tables(*(x.to(device) for x in (tables.next, tables.reward, tables.hidden,
                                           tables.done)), tables.max_steps, tables.reset_idx)


def _bad_calls(tables, hyper, greedy, state, step0, rand_a, u):
    """Every wrong input the wrapper raised on before, each with the message
    it raises."""
    st = list(state)
    yield "rand_a: expected \\[T, N\\]", (tables, hyper, greedy, state, step0, rand_a[0], u)
    yield "tables: expected", (_tables_on(tables, "meta"), hyper, greedy, state, step0,
                               rand_a, u)
    yield "greedy", (tables, hyper, greedy.to(torch.int64), state, step0, rand_a, u)
    yield "greedy", (tables, hyper, greedy[:-1], state, step0, rand_a, u)
    yield "state: expected 5", (tables, hyper, greedy, state[:4], step0, rand_a, u)
    for i, name in enumerate(("idx", "t", "ep_return", "ep_hidden", "ep_len")):
        wrong = st[:i] + [st[i].to(torch.float64)] + st[i + 1:]
        yield f"state.{name}", (tables, hyper, greedy, tuple(wrong), step0, rand_a, u)
    yield "state.idx", (tables, hyper, greedy, (st[0][:, :-1],) + tuple(st[1:]), step0,
                        rand_a, u)
    yield "step0", (tables, hyper, greedy, state, step0.to(torch.int32), rand_a, u)
    yield "step0", (tables, hyper, greedy, state, step0.reshape(()), rand_a, u)
    yield "rand_a", (tables, hyper, greedy, state, step0, rand_a.to(torch.int64), u)
    yield "rand_a", (tables, hyper, greedy, state, step0, rand_a.t().contiguous().t(), u)
    yield "u: expected", (tables, hyper, greedy, state, step0, rand_a, u.double())
    yield "u: expected", (tables, hyper, greedy, state, step0, rand_a, u[:, :-1])


def test_wrapper_still_raises_on_every_wrong_input(sokoban):
    n = 0
    for match, args in _bad_calls(*sokoban):
        with pytest.raises(ValueError, match=match):
            dk.dqn_collect(*args)
        n += 1
    assert n == 17


def test_wrapper_refuses_devices_it_has_no_kernel_for(sokoban):
    """Inputs that pass every check but lie on neither the CPU nor a card."""
    tables, hyper, greedy, state, step0, rand_a, u = sokoban
    meta = _tables_on(tables, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dk.dqn_collect(meta, hyper, greedy.to("meta"), tuple(x.to("meta") for x in state),
                       step0.to("meta"), rand_a.to("meta"), u.to("meta"))


@pytest.mark.parametrize("name", sorted(lc.B3_CASES))
def test_b3_cases_have_their_shapes(name):
    alias, N, T = lc.B3_CASES[name]
    tables, hyper, greedy, state, step0, rand_a, u = lc.dqn_collect_case(
        name, CPU, torch.Generator().manual_seed(0))
    assert rand_a.shape == u.shape == (T, N) and all(x.shape == (1, N) for x in state)
    assert greedy.shape == (tables.shape[0],) and step0.shape == (1,)
    assert 0.0 < hyper.epsilon and hyper.epsilon_final < 1.0


def test_ab_cases_hold_b3_bitwise():
    """The A/B tool's B3 cases against a second copy of this package (on
    the CPU both run the plain version): the check passes on equal outputs
    and raises on different ones."""
    lc.load_package(Path(dk.__file__).parents[2], "sga_ab_self")
    cases = abl._ab_cases(CPU, torch.Generator().manual_seed(0), "sga_ab_self", ("b3",))
    assert sorted(cases) == sorted(f"b3 {k}" for k in lc.B3_CASES)
    calls, check, small = cases["b3 sokoban main"]
    outs = {label: fn() for label, fn in calls.items()}
    assert small and check(outs)
    outs["new"] = outs["new"][:10] + (outs["new"][10] + 1,) + outs["new"][11:]
    with pytest.raises(AssertionError, match="differ"):
        check(outs)


def test_b3_launch_parts_cover_both_wrapper_designs():
    """``trace_learners``' split of B3's launch path names the same parts for
    this package's wrapper (one carved buffer) and for the first design's
    (15 ``torch.empty``); on the CPU only the allocation is timed."""
    from safe_grid_agents_torch.tools import trace_learners as tl
    args = lc.dqn_collect_case("sokoban main", CPU, torch.Generator().manual_seed(0))
    first = dataclasses.make_dataclass("FirstDesign", [])()  # no carve_outputs
    carved, alone = tl.b3_alloc(dk, args)(), tl.b3_alloc(first, args)()
    for outs in (carved, alone):
        assert [(x.dtype, tuple(x.shape)) for x in outs] == [
            (x.dtype, tuple(x.shape)) for x in dk.dqn_collect(*args)]
    assert carved[0].untyped_storage().nbytes() == 4 * (dk.HEAD_WORDS + 6 * 32 * 128 + 9 * 128)
