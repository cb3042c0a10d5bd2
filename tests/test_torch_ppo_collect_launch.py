"""B5's launch path on the CPU: the single-buffer outputs, the shared-memory
layout and the checks.

``ppo_collect`` hands the kernel one buffer for its 18 outputs
(``carve_outputs``, shared with B10's wrapper): the nine ``[T, N]``
records, then the lane state and the four accumulators, all 4-byte words,
at the offsets ``ppo_collect_launch`` writes them to. These tests write the
plain version's outputs into a buffer at those offsets and read them back
through the carved views, hold the kernel's shared-memory layout (mirrored
by ``smem_bytes``) to the card's cap on sokoban, and check that every wrong
input still raises: the tables when they are built (``Tables``), the rest
on each call.
"""
import dataclasses
from pathlib import Path

import pytest
import torch

from safe_grid_agents_torch.agents.ppo import PPOAgent
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.vec import VecEnv
from safe_grid_agents_torch.ops import ppo_collect_kernel as pck
from safe_grid_agents_torch.ops.rollout_kernel import SMEM_CAP, Tables
from safe_grid_agents_torch.tools import ab_learners as abl
from safe_grid_agents_torch.tools import learner_cases as lc
from safe_grid_agents_torch.training import FusedPPOTrainer

CPU = torch.device("cpu")

# Record r of the wrapper's order (pre_idx, pre_t, action, logp, value,
# reward, hidden, done, next_idx) sits at record slot RECORD_SLOTS[r] of the
# buffer (the int32 records first, then the float32 ones); lane output i
# (idx, t, ep_return, ep_hidden, ep_len, episodes, return, hidden, length)
# at lane slot LANE_SLOTS[i] after the records.
RECORD_SLOTS = (0, 1, 2, 5, 6, 7, 8, 3, 4)
LANE_SLOTS = (0, 1, 3, 4, 2, 5, 6, 7, 8)


def _inputs(alias, N, T, seed=0):
    cenv = make_env(alias, compiled=True, device="cpu")
    tr = FusedPPOTrainer(PPOAgent(cenv, net="table"), VecEnv(cenv, N))
    astate, vstate = tr.init(seed=seed)
    state = tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                    vstate.ep_hidden, vstate.ep_len))
    u = torch.rand((T, N), generator=torch.Generator().manual_seed(seed))
    return tr.tables, tr.policy_rows(astate.params), state, u


@pytest.fixture(scope="module")
def island():
    return _inputs("island", 33, 17)


def _kernel_write(outs, T, N) -> torch.Tensor:
    """A buffer filled as ``ppo_collect_launch`` fills it from the outputs
    ``outs`` (in the wrapper's order)."""
    buf = torch.empty(9 * (T + 1) * N, dtype=torch.int32)
    for r, slot in enumerate(RECORD_SLOTS):
        buf[slot * T * N:(slot + 1) * T * N] = outs[9 + r].reshape(-1).view(torch.int32)
    for i, slot in enumerate(LANE_SLOTS):
        at = 9 * T * N + slot * N
        buf[at:at + N] = outs[i].reshape(-1).view(torch.int32)
    return buf


@pytest.mark.parametrize("T, N", [(17, 33), (64, 1024), (0, 5)])
def test_carved_outputs_carry_the_plain_outputs(T, N):
    """Views of a buffer written at the kernel's offsets have the plain
    version's dtypes, shapes and values (a partial tile and warp, the island
    preset's chunk, and no steps at all)."""
    plain = pck.ppo_collect(*_inputs("island", N, T))
    written = _kernel_write(plain, T, N)
    buf, outs = pck.carve_outputs(T, N, "cpu")
    assert buf.dtype == torch.int32 and buf.numel() == written.numel() == 9 * (T + 1) * N
    buf.copy_(written)
    assert len(outs) == len(plain) == 18
    for i, (got, want) in enumerate(zip(outs, plain)):
        assert got.dtype == want.dtype and got.shape == want.shape, i
        assert got.is_contiguous(), i
        assert torch.equal(got, want), i


def test_records_are_16_byte_aligned_for_the_bulk_stores():
    """Each record starts at a multiple of 4 words of the buffer when N is a
    multiple of 4 (the kernel's 16-byte stores need it)."""
    T, N = 17, 1024
    buf, outs = pck.carve_outputs(T, N, "cpu")
    base = buf.data_ptr()
    assert all((x.data_ptr() - base) % 16 == 0 for x in outs[9:])


@pytest.mark.parametrize("alias", ["island", "sokoban"])
def test_tiles_fit_beside_the_tables(alias):
    """The uniform and record tiles (22.5 KB) fit beside the tables and
    policy rows in one block's shared memory: sokoban's 1296 states take
    109 KB of them, the largest alias the deterministic PPO path runs."""
    cenv = make_env(alias, compiled=True, device="cpu")
    S, A = VecEnv(cenv, 1).S, VecEnv(cenv, 1).A
    tables_and_rows = 13 * S * A + 4 * S * 2 * A
    need = pck.smem_bytes(S, A)
    assert pck.TILE_BYTES == 4 * 32 * 16 * (2 + 9)
    assert tables_and_rows + pck.TILE_BYTES <= need <= tables_and_rows + pck.TILE_BYTES + 7 * 15
    assert need <= SMEM_CAP


def test_tables_are_checked_when_built(island):
    tables = island[0]
    for field, bad in (("next", tables.next.to(torch.int64)),
                       ("reward", tables.reward.to(torch.float64)),
                       ("hidden", tables.hidden[:, :2]),
                       ("done", tables.done.t()),
                       ("next", tables.next.reshape(-1))):
        with pytest.raises(ValueError, match="tables.next|tables." + field):
            dataclasses.replace(tables, **{field: bad})
    with pytest.raises(ValueError, match="tables.reward"):
        dataclasses.replace(tables, reward=tables.reward.to("meta"))


def _tables_on(tables, device):
    return Tables(*(x.to(device) for x in (tables.next, tables.reward, tables.hidden,
                                           tables.done)), tables.max_steps, tables.reset_idx)


def _bad_calls(tables, rows, state, u):
    """Every wrong input the wrapper raised on before, each with the message
    it raises."""
    st = list(state)
    yield "u: expected", (tables, rows, state, u[0])
    one_action = Tables(*(x[:, :1].contiguous() for x in (tables.next, tables.reward,
                                                          tables.hidden, tables.done)),
                        tables.max_steps, tables.reset_idx)
    yield "at least two actions", (one_action, rows, state, u)
    yield "tables: expected", (_tables_on(tables, "meta"), rows, state, u)
    yield "rows.logp", (tables, dataclasses.replace(rows, logp=rows.logp.double()), state, u)
    yield "rows.cdf", (tables, dataclasses.replace(rows, cdf=rows.logp), state, u)
    yield "rows.value", (tables, dataclasses.replace(rows, value=rows.value[:-1]), state, u)
    yield "rows.logp", (tables, dataclasses.replace(rows, logp=rows.logp.t().contiguous().t()),
                        state, u)
    yield "state: expected 5", (tables, rows, state[:4], u)
    for i, name in enumerate(("idx", "t", "ep_return", "ep_hidden", "ep_len")):
        wrong = st[:i] + [st[i].to(torch.float64)] + st[i + 1:]
        yield f"state.{name}", (tables, rows, tuple(wrong), u)
    yield "state.idx", (tables, rows, (st[0][:, :-1],) + tuple(st[1:]), u)
    yield "u: expected", (tables, rows, state, u.double())
    yield "u: expected", (tables, rows, state, u.t().contiguous().t())


def test_wrapper_still_raises_on_every_wrong_input(island):
    tables, rows, state, u = island
    n = 0
    for match, args in _bad_calls(tables, rows, state, u):
        with pytest.raises(ValueError, match=match):
            pck.ppo_collect(*args)
        n += 1
    assert n == 16


def test_wrapper_refuses_devices_it_has_no_kernel_for(island):
    """Inputs that pass every check but lie on neither the CPU nor a card."""
    tables, rows, state, u = island
    meta = _tables_on(tables, "meta")
    rows = dataclasses.replace(rows, **{f.name: getattr(rows, f.name).to("meta")
                                        for f in dataclasses.fields(rows)})
    with pytest.raises(ValueError, match="unsupported device"):
        pck.ppo_collect(meta, rows, tuple(x.to("meta") for x in state), u.to("meta"))


@pytest.mark.parametrize("name", sorted(lc.B5_CASES))
def test_b5_cases_have_their_shapes(name):
    alias, N, T = lc.B5_CASES[name]
    tables, rows, state, u = lc.ppo_collect_case(name, CPU, torch.Generator().manual_seed(0))
    S, A = tables.shape
    assert u.shape == (T, N) and all(x.shape == (1, N) for x in state)
    assert rows.logp.shape == (S, A) and rows.cdf.shape == (S, A - 1)


def test_ab_cases_hold_b5_bitwise_and_b11_to_plain():
    """The A/B tool's B5 and B11 cases against a second copy of this package
    (on the CPU both run the plain versions): the B5 check passes on equal
    outputs and raises on different ones; the B11 check holds both to the
    plain version within atol 1e-5."""
    lc.load_package(Path(pck.__file__).parents[2], "sga_ab_self")
    g = torch.Generator().manual_seed(0)
    cases = abl._ab_cases(CPU, g, "sga_ab_self", ("b5", "b11"))
    assert sorted(cases) == sorted([f"b5 {k}" for k in lc.B5_CASES]
                                   + [f"b11 {k}" for k in lc.B11_CASES])
    for case in ("b5 island edge", "b11 collect"):
        calls, check, small = cases[case]
        outs = {label: fn() for label, fn in calls.items()}
        assert small and check(outs)
    calls, check, _ = cases["b5 island edge"]
    outs = {label: fn() for label, fn in calls.items()}
    outs["new"] = outs["new"][:9] + (outs["new"][9] + 1,) + outs["new"][10:]
    with pytest.raises(AssertionError, match="differ"):
        check(outs)
