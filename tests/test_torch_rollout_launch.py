"""B1's launch path and its packed table on the CPU: the single-buffer
outputs, the kernel's packed entries and shared-memory layout, and the
checks.

``rollout`` hands the kernel one buffer for its 8 outputs
(``carve_outputs``) and the addresses of the outputs in it. The kernel packs
each (s, a) entry into one 16-byte word in its prologue (mirrored by
``packed_entries``): the successor's row offset with the terminal reset
folded in, the reward, the hidden reward and the done flag, so that a step
makes one shared-memory load and selects only on the time limit. These
tests write the plain version's outputs into a buffer at the kernel's
offsets and read them back through the carved views, hold the packed
entries to the four tables, walk a model of the kernel's step over the
packed entries against the plain version bitwise, hold the kernel's
shared-memory layout (``smem_bytes``) to the card's cap for every
deterministic alias the port runs, and check that every wrong input still
raises.
"""
import dataclasses

import pytest
import torch

from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.ops import _build
from safe_grid_agents_torch.ops import rollout_kernel as rk
from safe_grid_agents_torch.ops.rollout_kernel import SMEM_CAP, Tables
from safe_grid_agents_torch.tools import ab_rollout, variants

CPU = torch.device("cpu")
# The deterministic aliases the port runs on the rollout engine.
ALIASES = ("shift", "shift-test", "island", "sokoban")


@pytest.fixture(scope="module")
def engines():
    return {alias: rk.RolloutEngine(make_env(alias, compiled=True, device="cpu"), 33)
            for alias in ALIASES}


def _mid_episode(eng, n, g):
    reach = eng.cenv.reachable
    return (reach[torch.randint(0, len(reach), (1, n), generator=g)].to(torch.int32),
            torch.randint(0, eng.max_steps, (1, n), dtype=torch.int32, generator=g),
            torch.randint(-30, 5, (1, n), generator=g).to(torch.float32),
            torch.randint(-30, 5, (1, n), generator=g).to(torch.float32),
            torch.randint(0, 60, (1, n), dtype=torch.int32, generator=g))


def _inputs(eng, n, T, start, seed=0):
    g = torch.Generator().manual_seed(seed)
    state = rk.reset_state(n, eng.reset_idx, CPU) if start == "reset" else _mid_episode(eng, n, g)
    actions = torch.randint(0, eng.A, (T, n), dtype=torch.int32, generator=g)
    return state, actions


def packed_model(tables: Tables, state, actions):
    """The kernel's step over its packed table in plain PyTorch: one entry
    a step, the lane's position a byte offset of its state's row, the next
    position the packed successor unless the time limit hits (the terminal
    reset is in the entry), the episode sums in the plain version's order."""
    A = tables.shape[1]
    row = rk.PACKED_BYTES * A
    pack = rk.packed_entries(tables)
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    at = idx * row
    racc, eacc, facc = (torch.zeros_like(epr) for _ in range(3))
    for a in actions:
        e = pack[((at + rk.PACKED_BYTES * a) // rk.PACKED_BYTES).long()]
        r, h = e[:, 1].view(torch.float32), e[:, 2].view(torch.float32)
        t1 = t + 1
        timeout = t1 >= tables.max_steps
        done = (e[:, 3] != 0) | timeout
        dx = done.to(torch.float32)
        epr = epr + r
        eph = eph + h
        epl = epl + 1
        racc = racc + r
        eacc = eacc + dx
        facc = facc + dx * epr
        at = torch.where(timeout, torch.full_like(at, tables.reset_idx * row), e[:, 0])
        t = torch.where(done, torch.zeros_like(t1), t1)
        epr = torch.where(done, torch.zeros_like(epr), epr)
        eph = torch.where(done, torch.zeros_like(eph), eph)
        epl = torch.where(done, torch.zeros_like(epl), epl)
    return tuple(x[None] for x in (at // row, t, epr, eph, epl, racc, eacc, facc))


@pytest.mark.parametrize("alias", ALIASES)
def test_packed_entries_hold_the_four_tables_with_the_reset_folded_in(engines, alias):
    tables = engines[alias].tables
    S, A = tables.shape
    pack = rk.packed_entries(tables)
    assert pack.dtype == torch.int32 and pack.shape == (S * A, 4)
    done = tables.done.view(-1) != 0
    succ = pack[:, 0]
    assert bool((succ % (rk.PACKED_BYTES * A) == 0).all())
    succ = succ // (rk.PACKED_BYTES * A)
    assert torch.equal(succ[~done], tables.next.view(-1)[~done])
    assert bool((succ[done] == tables.reset_idx).all()) and bool(done.any())
    assert torch.equal(pack[:, 1].view(torch.float32), tables.reward.view(-1))
    assert torch.equal(pack[:, 2].view(torch.float32), tables.hidden.view(-1))
    assert torch.equal(pack[:, 3], done.to(torch.int32))
    assert int(pack[:, 0].max()) < 2 ** 31  # int32 byte offsets


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize("start", ["reset", "mid-episode"])
@pytest.mark.parametrize("T", [0, 17, 150])
def test_packed_step_model_equals_the_plain_version(engines, alias, start, T):
    """A step over the packed entries, selecting only on the time limit,
    gives the plain version's 8 outputs bitwise (T = 150 passes the
    100-step limit from a reset)."""
    eng = engines[alias]
    state, actions = _inputs(eng, 33, T, start, seed=T)
    got = packed_model(eng.tables, state, actions)
    want = rk.rollout_reference(eng.tables, state, actions)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


def _kernel_write(outs, N) -> torch.Tensor:
    """A buffer filled as ``rollout_launch`` fills it, through the addresses
    the wrapper hands it (``OUT_WORDS``), from the outputs ``outs``."""
    buf = torch.zeros(8 * N, dtype=torch.int32)
    for x, w in zip(outs, rk.OUT_WORDS):
        buf[w * N:(w + 1) * N] = x.reshape(-1).view(torch.int32)
    return buf


@pytest.mark.parametrize("T, N", [(17, 33), (64, 128), (0, 5), (3, 1)])
def test_carved_outputs_carry_the_plain_outputs(engines, T, N):
    eng = engines["shift"]
    state, actions = _inputs(eng, N, T, "mid-episode")
    plain = rk.rollout(eng.tables, state, actions)
    buf, outs = rk.carve_outputs(N, "cpu")
    assert buf.dtype == torch.int32 and buf.numel() == 8 * N
    buf.copy_(_kernel_write(plain, N))
    assert len(outs) == len(plain) == 8
    for i, (got, want) in enumerate(zip(outs, plain)):
        assert got.dtype == want.dtype and got.shape == want.shape == (1, N), i
        assert got.is_contiguous() and torch.equal(got, want), i


@pytest.mark.parametrize("N", [1, 33, 4096])
def test_carved_views_tile_the_buffer(N):
    buf, outs = rk.carve_outputs(N, torch.device("meta"))
    words = sorted(x.storage_offset() for x in outs)
    assert words == [w * N for w in range(8)]
    assert [outs[i].storage_offset() for i in range(8)] == [w * N for w in rk.OUT_WORDS]


@pytest.mark.parametrize("alias", ALIASES)
def test_shared_memory_fits_for_every_deterministic_alias(engines, alias):
    """Action tiles (two of 128 steps, 32 KB), the packed table (16 bytes a
    cell) and the raw tables it is packed from (13 bytes a cell, each array
    16-byte aligned) fit one block's 227 KB; sokoban, S·A = 5184, is the
    largest."""
    S, A = engines[alias].tables.shape
    need = rk.smem_bytes(S, A)
    assert rk.TILE_BYTES == 2 * 4 * 32 * 128
    assert rk.TILE_BYTES + 29 * S * A <= need <= rk.TILE_BYTES + 29 * S * A + 4 * 15
    assert need <= SMEM_CAP
    if alias == "sokoban":
        assert S * A == 5184 and rk.TILE_BYTES + 16 * S * A == 115712
        assert 180_000 < need < 185_000


def test_smem_check_states_the_packed_size():
    """A table too large for one block is refused with the bytes it needs."""
    S, A = 2000, 4
    tables = Tables(torch.zeros((S, A), dtype=torch.int32), torch.zeros((S, A)),
                    torch.zeros((S, A)), torch.zeros((S, A), dtype=torch.uint8), 100, 0)
    need = rk.smem_bytes(S, A)
    assert need > SMEM_CAP
    with pytest.raises(ValueError, match=f"need {need} bytes"):
        rk.check_smem(need, tables)


def _tables_on(tables, device):
    return Tables(*(x.to(device) for x in (tables.next, tables.reward, tables.hidden,
                                           tables.done)), tables.max_steps, tables.reset_idx)


def test_tables_are_checked_when_built(engines):
    tables = engines["shift"].tables
    for field, bad in (("next", tables.next.to(torch.int64)),
                       ("reward", tables.reward.to(torch.float64)),
                       ("hidden", tables.hidden[:, :2]),
                       ("done", tables.done.t())):
        with pytest.raises(ValueError, match="tables." + field):
            dataclasses.replace(tables, **{field: bad})


def test_wrapper_still_raises_on_every_wrong_input(engines):
    tables = engines["shift"].tables
    state, actions = _inputs(engines["shift"], 33, 17, "mid-episode")
    st = list(state)
    bad = [("actions: expected \\[T, N\\]", (tables, state, actions[0])),
           ("tables: expected", (_tables_on(tables, "meta"), state, actions)),
           ("state: expected 5", (tables, state[:4], actions)),
           ("state.idx", (tables, (st[0][:, :-1],) + tuple(st[1:]), actions)),
           ("actions", (tables, state, actions.to(torch.int64))),
           ("actions", (tables, state, actions.t().contiguous().t()))]
    for i, name in enumerate(("idx", "t", "ep_return", "ep_hidden", "ep_len")):
        wrong = st[:i] + [st[i].to(torch.float64)] + st[i + 1:]
        bad.append((f"state.{name}", (tables, tuple(wrong), actions)))
    for match, args in bad:
        with pytest.raises(ValueError, match=match):
            rk.rollout(*args)
    meta = _tables_on(tables, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rk.rollout(meta, tuple(x.to("meta") for x in state), actions.to("meta"))


def test_run_random_reduced_draws_one_action_matrix(engines):
    """The engine's API: one ``[T, N]`` randint from the generator, the
    chunk totals out, the carried state composing over chunks."""
    eng = engines["shift"]
    state = eng.reset()
    mid, acc = eng.run_random_reduced(state, torch.Generator().manual_seed(3), 40)
    end, acc2 = eng.run_random_reduced(mid, torch.Generator().manual_seed(4), 60)
    g = torch.Generator().manual_seed(3)
    a1 = torch.randint(0, eng.A, (40, 33), dtype=torch.int32, generator=g)
    g = torch.Generator().manual_seed(4)
    a2 = torch.randint(0, eng.A, (60, 33), dtype=torch.int32, generator=g)
    first = rk.rollout_reference(eng.tables, state, a1)
    second = rk.rollout_reference(eng.tables, first[:5], a2)
    assert all(torch.equal(a, b) for a, b in zip(end, second[:5]))
    assert float(acc["reward_sum"]) == float(first[5].sum())
    assert int(acc2["episodes"]) == int(second[6].sum())


def test_step_parts_still_match_the_source(tmp_path):
    """The A/B tool's part variants are text substitutions of the kernel's
    source; each still matches it, and each changes it."""
    paths = ab_rollout.part_sources(_build.CSRC / "rollout_kernel.cu", tmp_path)
    src = (_build.CSRC / "rollout_kernel.cu").read_text()
    assert list(paths) == list(ab_rollout.PARTS)
    texts = [p.read_text() for p in paths.values()]
    assert texts[0] == src and all(t != src for t in texts[1:])
    assert len(set(texts)) == len(texts)


def test_opcode_counts_read_sass_lines():
    sass = ("        /*0040*/                   LDS.128 R4, [R2+0x1000] ;\n"
            "        /*0050*/               @!P0 IADD3 R2, R2, 0x10, RZ ;\n"
            "        /*0060*/                   LDS.128 R8, [R2] ;\n")
    assert variants.opcode_counts(sass) == {"LDS": 2, "IADD3": 1}
