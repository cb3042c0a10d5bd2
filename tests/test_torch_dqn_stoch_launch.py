"""B9's launch path on the CPU: the single-buffer outputs, the placement and
tile depth the kernel picks, and the checks.

``dqn_stoch_collect`` hands the kernel one buffer for its 16 outputs, laid
out as B3's (``dqn_kernel.carve_outputs``): the int64 step in a 16-byte
head, the six ``[T, N]`` records, then the lane state and the four
accumulators, all 4-byte words, at the offsets ``dqn_stoch_collect_launch``
writes them to. These tests write the plain version's outputs into a buffer
at those offsets and read them back through the carved views, hold the
alignments the kernel's 16-byte stores need, hold the kernel's choice of
placement and tile depth (mirrored by ``layout``) to the card's cap for
every stochastic alias, and check that every wrong input still raises.
"""
import dataclasses
from pathlib import Path

import pytest
import torch

from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.vec import VecEnv
from safe_grid_agents_torch.ops import dqn_kernel as dk
from safe_grid_agents_torch.ops import dqn_stoch_kernel as dsk
from safe_grid_agents_torch.ops.rollout_kernel import SMEM_CAP
from safe_grid_agents_torch.tools import ab_learners as abl
from safe_grid_agents_torch.tools import learner_cases as lc

CPU = torch.device("cpu")

# Record r of the wrapper's order (pre_idx, pre_t, action, reward, next_idx,
# done) sits at record slot RECORD_SLOTS[r] of the buffer (the int32
# records first, then reward); lane output i (idx, t, ep_return, ep_hidden,
# ep_len, then after the step episodes, return, hidden, length) at lane
# slot LANE_SLOTS[i] after the records.
RECORD_SLOTS = (0, 1, 2, 5, 3, 4)
LANE_SLOTS = (0, 1, 3, 4, 2, 5, 6, 7, 8)

# Each alias of the card legs' STOCH_COLLECT_CASES: its compile kwargs, and
# the placement and tile depth the kernel picks for it.
LAYOUTS = {
    "absent": ({}, "shared", 128), "interrupt": ({}, "shared", 128),
    "whisky": ({}, "shared", 128), "tomato": ({}, "shared", 128),
    "friend@15": ({"cap": 15}, "shared", 32),
    "friend@127": ({"cap": 127}, "global", 128),
}


@pytest.fixture(scope="module")
def tables():
    cache = {}

    def get(alias):
        if alias not in cache:
            kw = LAYOUTS[alias][0]
            cenv = make_env(alias.partition("@")[0], compiled=True, device="cpu", **kw)
            cache[alias] = VecEnv(cenv, 1).tables
        return cache[alias]
    return get


def _case(alias, N, T, seed=0, **kw):
    return lc.dqn_stoch_collect_case(None, CPU, torch.Generator().manual_seed(seed),
                                     shape=(alias, {}, N, T), **kw)


def _kernel_write(outs, T, N) -> torch.Tensor:
    """A buffer filled as ``dqn_stoch_collect_launch`` fills it from the
    outputs ``outs`` (in the wrapper's order)."""
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


@pytest.mark.parametrize("cheat", [False, True])
@pytest.mark.parametrize("N", [1, 33, 128])
@pytest.mark.parametrize("T", [16, 32, 1024])
def test_carved_views_tile_the_buffer_and_carry_the_plain_outputs(T, N, cheat):
    """Views of a buffer written at the kernel's offsets have the plain
    version's dtypes, shapes and values (whisky: the stumble, with the
    observed or the hidden reward recorded), and with the head's two pad
    words they cover the buffer without overlapping."""
    args = list(_case("whisky", N, T, greedy="random", start="mid-episode"))
    args[1] = dataclasses.replace(args[1], use_hidden=cheat)
    plain = dsk.dqn_stoch_collect(*args)
    written = _kernel_write(plain, T, N)
    buf, outs = dk.carve_outputs(T, N, "cpu")
    assert buf.dtype == torch.int32 and buf.numel() == written.numel()
    buf.copy_(written)
    assert len(outs) == len(plain) == 16
    for i, (got, want) in enumerate(zip(outs, plain)):
        assert got.dtype == want.dtype and got.shape == want.shape, i
        assert got.is_contiguous(), i
        assert torch.equal(got, want), i
    words = [x.storage_offset() * x.element_size() // 4 for x in outs]
    spans = sorted((w, w + x.numel() * x.element_size() // 4) for w, x in zip(words, outs))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[0] == (0, 2) and spans[1][0] == dk.HEAD_WORDS
    assert spans[-1][1] == buf.numel() and sum(b - a for a, b in spans) == buf.numel() - 2


@pytest.mark.parametrize("alias", sorted(LAYOUTS))
def test_each_alias_gets_the_deepest_tile_that_fits(alias, tables):
    """The placement and tile depth of every alias of the card legs: the
    tables and the greedy row in shared memory up to friend at cap 15,
    which keeps them only with 32-step tiles, and both in device memory at
    cap 127; a deeper tile would not fit at the same placement, and the
    bytes are the draw tiles', the record tile's (with the tables in device
    memory), the ε tile's, and the staged tables' and greedy row's."""
    _, place, tile = LAYOUTS[alias]
    t = tables(alias)
    assert dsk.layout(t) == (place, tile, dsk.layout_bytes(t, place, tile))
    assert (dsk.collect_placement(t), dsk.tile_steps(t)) == (place, tile)
    assert dsk.smem_bytes(t) <= SMEM_CAP
    if tile < dsk.TILES[0]:
        assert dsk.layout_bytes(t, place, 2 * tile) > SMEM_CAP
    S, A = t.shape
    streams = 2 + int(bool(t.mode or t.dry_nbits)) + 2 * int(t.noise)
    tiles = 4 * 32 * tile * (2 * streams + (0 if place == "shared" else 6)) + 4 * tile
    staged = {"shared": 13 * S * A + 8 * S * A * (t.mode == 2) + S * t.noise + 4 * S,
              "global": 0}[place]
    assert tiles + staged <= dsk.smem_bytes(t) <= tiles + staged + 8 * 15


def test_friend_at_cap_15_keeps_shared_memory_only_with_32_step_tiles(tables):
    """The placement comes before the depth: friend at cap 15 keeps its
    tables in shared memory under 32-step tiles, although with the tables
    in device memory 128-step tiles would fit."""
    t = tables("friend@15")
    assert dsk.layout_bytes(t, "shared", 64) > SMEM_CAP >= dsk.layout_bytes(t, "shared", 32)
    assert dsk.layout_bytes(t, "global", 128) <= SMEM_CAP
    assert dsk.layout(t)[:2] == ("shared", 32)


@pytest.mark.parametrize("S, N, T", lc.B9_SYNTHETIC)
def test_random_tables_take_the_placements_no_alias_takes(S, N, T):
    """Random carried-reset tables: at 2,400 states the tables and the
    greedy row fit in shared memory beside 16-step tiles only; at 60,000
    they do not fit beside 16-step tiles, so both stay in device memory and
    the tiles take 128 steps."""
    args = lc.synthetic_stoch_case(S, N, T, CPU, torch.Generator().manual_seed(0))
    if S == 2400:
        assert dsk.layout(args[0]) == ("shared", 16, 4 * 32 * 16 * 6 + 4 * 16 + 21 * S * 4 + 4 * S)
        assert dsk.layout_bytes(args[0], "shared", 32) > SMEM_CAP
    else:
        assert dsk.layout(args[0]) == ("global", 128, 4 * 32 * 128 * (2 * 3 + 6) + 4 * 128)
        assert dsk.layout_bytes(args[0], "shared", 16) > SMEM_CAP


def test_b9_edges_cover_what_they_claim(tables):
    """``learner_cases.B9_EDGES`` holds a partial last tile under deeper
    tiles, a partial block, a single lane, the tables in device memory, and
    no steps."""
    seen = set()
    for alias, kw, n, T, _ in lc.B9_EDGES:
        key = f"{alias}@{kw['cap']}" if kw else alias
        place, tile, _ = dsk.layout(tables(key))
        if T % tile and tile > 16:
            seen.add("partial tile")
        if n % 32:
            seen.add("partial block")
        seen.update({"one lane"} if n == 1 else set())
        seen.update({"tables in device memory"} if place == "global" else set())
        seen.update({"no steps"} if T == 0 else set())
        assert T % dsk.TB_DS == 0
    assert seen == {"partial tile", "partial block", "one lane", "tables in device memory",
                    "no steps"}


def _bad_calls(tables, hyper, greedy, state, step0, rand_a, u, bits, stumble, rand2):
    """Every wrong input the wrapper raised on before, each with the message
    it raises."""
    st = list(state)
    streams = [rand_a, u, bits, stumble, rand2]

    def call(**kw):
        d = dict(tables=tables, hyper=hyper, greedy=greedy, state=state, step0=step0)
        s = list(streams)
        for i, name in enumerate(dsk.STREAMS):
            if name in kw:
                s[i] = kw.pop(name)
        d.update(kw)
        return (d["tables"], d["hyper"], d["greedy"], d["state"], d["step0"], *s)

    yield "rand_a: expected \\[T, N\\]", call(rand_a=rand_a[0])
    yield "multiple of 16", call(**{n: x[:24] for n, x in zip(dsk.STREAMS, streams)})
    yield "tables.next", call(tables=dataclasses.replace(tables, next=tables.next.long()))
    yield "tables.reward", call(tables=dataclasses.replace(tables, reward=tables.reward[:, :2]))
    yield "tables.done", call(tables=dataclasses.replace(tables, done=tables.done.bool()))
    yield "tables.drunk", call(tables=dataclasses.replace(tables, drunk=tables.drunk[:-1]))
    yield "drying shares the bits stream", call(tables=dataclasses.replace(tables, dry_nbits=2))
    yield "greedy", call(greedy=greedy.to(torch.int64))
    yield "greedy", call(greedy=greedy[:-1])
    yield "state: expected 5", call(state=state[:4])
    for i, name in enumerate(("idx", "t", "ep_return", "ep_hidden", "ep_len")):
        wrong = st[:i] + [st[i].to(torch.float64)] + st[i + 1:]
        yield f"state.{name}", call(state=tuple(wrong))
    yield "state.idx", call(state=(st[0][:, :-1],) + tuple(st[1:]))
    yield "step0", call(step0=step0.to(torch.int32))
    yield "step0", call(step0=step0.reshape(()))
    for name, x in zip(dsk.STREAMS, streams):
        yield f"{name}: expected", call(**{name: x.double()})
        if name != "rand_a":  # rand_a gives N: a narrower one fails on the state first
            yield f"{name}: expected", call(**{name: x[:, :-1]})
    yield "rand_a: expected", call(rand_a=rand_a.t().contiguous().t())


def test_wrapper_still_raises_on_every_wrong_input():
    n = 0
    for match, args in _bad_calls(*_case("whisky", 8, 32)):
        with pytest.raises(ValueError, match=match):
            dsk.dqn_stoch_collect(*args)
        n += 1
    assert n == 28


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    """Inputs that pass every check but lie on neither the CPU nor a card."""
    tables, hyper, *rest = _case("whisky", 8, 32)
    fields = {f.name: getattr(tables, f.name) for f in dataclasses.fields(tables)}
    meta = dataclasses.replace(tables, **{k: v.to("meta") for k, v in fields.items()
                                          if torch.is_tensor(v)})
    moved = [tuple(x.to("meta") for x in r) if isinstance(r, tuple) else r.to("meta")
             for r in rest]
    with pytest.raises(ValueError, match="unsupported device"):
        dsk.dqn_stoch_collect(meta, hyper, *moved)


@pytest.mark.parametrize("name", sorted(lc.B9_CASES))
def test_b9_cases_have_their_shapes(name):
    """Each case's alias and placement, at its own shape for the command's
    chunk and cut to N = 8, T = 16 for the full-width ones (their streams
    take 64 MB each)."""
    alias, kw, N, T = lc.B9_CASES[name]
    shape = (alias, kw, N, T) if N * T <= 1 << 16 else (alias, kw, 8, 16)
    args = lc.dqn_stoch_collect_case(name, CPU, torch.Generator().manual_seed(0), shape=shape)
    tables, hyper, greedy, state, step0, *streams = args
    _, _, n, t = shape
    assert all(x.shape == (t, n) for x in streams) and all(x.shape == (1, n) for x in state)
    assert greedy.shape == (tables.shape[0],) and step0.shape == (1,)
    assert 0.0 < hyper.epsilon and hyper.epsilon_final < 1.0
    assert (dsk.collect_placement(tables) == "shared") == (alias != "friend")


def test_ab_cases_hold_b9_bitwise(monkeypatch):
    """The A/B tool's B9 cases against a second copy of this package (on
    the CPU both run the plain version): the check passes on equal outputs
    and raises on different ones. The full-width cases are cut to N = 33,
    T = 48 here."""
    monkeypatch.setattr(lc, "B9_CASES", {k: (a, kw, 33, 48) if N > 128 else (a, kw, N, T)
                                         for k, (a, kw, N, T) in lc.B9_CASES.items()})
    lc.load_package(Path(dsk.__file__).parents[2], "sga_ab_self")
    cases = abl._ab_cases(CPU, torch.Generator().manual_seed(0), "sga_ab_self", ("b9",))
    assert sorted(cases) == sorted(f"b9 {k}" for k in lc.B9_CASES)
    for case, (calls, check, small) in cases.items():
        outs = {label: fn() for label, fn in calls.items()}
        assert small and check(outs), case
    outs["new"] = outs["new"][:10] + (outs["new"][10] + 1,) + outs["new"][11:]
    with pytest.raises(AssertionError, match="differ"):
        check(outs)


def test_b9_launch_parts_cover_both_wrapper_designs():
    """``trace_learners``' split of B9's launch path allocates, for this
    package's wrapper (one carved buffer) and for the first design's (15
    ``torch.empty`` and the step), the outputs the wrapper returns; on the
    CPU only the allocation is timed."""
    from safe_grid_agents_torch.tools import trace_learners as tl
    args = _case("whisky", 128, 32)
    first = dataclasses.make_dataclass("FirstDesign", [])()  # no carve_outputs
    carved, alone = tl.b3_alloc(dsk, args)(), tl.b3_alloc(first, args)()
    for outs in (carved, alone):
        assert [(x.dtype, tuple(x.shape)) for x in outs] == [
            (x.dtype, tuple(x.shape)) for x in dsk.dqn_stoch_collect(*args)]
    assert carved[0].untyped_storage().nbytes() == 4 * (dk.HEAD_WORDS + 6 * 32 * 128 + 9 * 128)
