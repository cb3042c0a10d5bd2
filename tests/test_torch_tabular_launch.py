"""B2's launch path and its step design on the CPU: the single-buffer
outputs, a model of the kernel's step, its shared-memory layout, and the
checks.

``tabq`` hands the kernel one buffer for its 11 outputs (``carve_outputs``)
and the addresses of the outputs in it (``out_pointers``): the int64 step
in a 16-byte head, Q, then the lane state and the four accumulators. The
kernel packs each (s, a) entry into one 16-byte word in its prologue
(``packed_entries``: the successor with the terminal reset folded in),
stages the draws in tiles with each step's ε computed once a tile, and
updates only the cells a step touched: each by its owner (the first adder
of its count), from exact fixed-point TD sums. These
tests write the plain version's outputs into a buffer at the kernel's
offsets and read them back through the carved views, walk a model of the
kernel's step and update against the plain version (bitwise: both sum the
TD errors in 64-bit fixed point), hold the shared-memory layout (``smem_bytes``,
``tile_steps``) to the card's cap for every deterministic alias the port
runs, and check that every wrong input still raises.
"""
from pathlib import Path

import pytest
import torch

from safe_grid_agents_torch.agents.tabular import TabularQAgent
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.vec import VecEnv
from safe_grid_agents_torch.ops import tabular_kernel as tk
from safe_grid_agents_torch.ops.rollout_kernel import SMEM_CAP, Tables
from safe_grid_agents_torch.tools import ab_learners as abl
from safe_grid_agents_torch.tools import learner_cases as lc
from safe_grid_agents_torch.training import FusedTabularQTrainer

CPU = torch.device("cpu")
ALIASES = ("shift", "shift-test", "island", "sokoban")


def _trainer(alias, N):
    cenv = make_env(alias, compiled=True, device="cpu")
    return FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000),
                                VecEnv(cenv, N))


def _inputs(alias, N, T, start, seed=0):
    """``tabq``'s arguments: from a reset with zero Q at step 0 (ε = 1),
    from the hot-cell start (a reset, zero Q, late in the anneal: most
    lanes take action 0 of the reset state), or from random lanes near the
    time limit with a random Q (lanes time out inside the chunk)."""
    tr = _trainer(alias, N)
    g = torch.Generator().manual_seed(seed)
    state = tr.init()[1]
    q = torch.zeros(tr.S, tr.A)
    step0 = torch.tensor([15_000 if start == "hot" else 0], dtype=torch.int64)
    if start == "random":
        reach = tr.vec.cenv.reachable
        state = (reach[torch.randint(0, len(reach), (1, N), generator=g)].to(torch.int32),
                 torch.randint(90, 100, (1, N), dtype=torch.int32, generator=g),
                 torch.randint(-30, 5, (1, N), generator=g).to(torch.float32),
                 torch.randint(-30, 5, (1, N), generator=g).to(torch.float32),
                 torch.randint(0, 60, (1, N), dtype=torch.int32, generator=g))
        q = torch.randn(tr.S, tr.A, generator=g)
        step0 = torch.tensor([5_000], dtype=torch.int64)
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g)
    u = torch.rand((T, N), generator=g)
    return tr.tables, tr.hyper, q, state, step0, rand_a, u


def kernel_model(tables, hyper, q, state, step0, rand_a, u):
    """The kernel's step and update in plain PyTorch: the packed entry, ε of
    the step, and the touched-cell update: each cell's fixed-point TD sum
    (the lanes' atomic adds, exact in any order) applied once by its owner,
    the first adder of the cell's count; no other cell is written."""
    S, A = tables.shape
    T, N = rand_a.shape
    lr, gamma, eps0, eps_delta, anneal = (torch.tensor(v, dtype=torch.float32)
                                          for v in hyper.f32())
    pack = tk.packed_entries(tables)
    q = q.clone()
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    eacc, racc, hacc, lacc = (torch.zeros_like(epr) for _ in range(4))
    for s in range(T):
        frac = ((step0 + s * N).to(torch.float32) / anneal).clamp(0.0, 1.0)
        greedy = q[idx.long()].argmax(-1).to(torch.int32)
        act = torch.where(u[s] < eps0 + frac * eps_delta, rand_a[s], greedy)
        k = idx.long() * A + act.long()
        e = pack[k]
        nxt, r, h = e[:, 0], e[:, 1].view(torch.float32), e[:, 2].view(torch.float32)
        t1 = t + 1
        timeout = t1 >= tables.max_steps
        done = (e[:, 3] != 0) | timeout
        boot = q[nxt.long()].amax(-1)
        td = r + gamma * torch.where(done, torch.zeros_like(boot), boot) - q.view(-1)[k]
        td_fx = torch.round(td * tk.TD_SCALE).to(torch.int64)
        owners = torch.unique(k)
        total = torch.zeros(S * A, dtype=torch.int64).index_add_(0, k, td_fx)[owners]
        cnt = torch.bincount(k, minlength=S * A)[owners]
        avg = (total.to(torch.float64) / tk.TD_SCALE).to(torch.float32)
        flat = q.view(-1)
        flat[owners] = flat[owners] + (lr * avg) / cnt.to(torch.float32).clamp_min(1.0)
        assert not bool(((q == 0) & torch.signbit(q)).any())  # no -0.0 ever
        dx = done.to(torch.float32)
        epr = epr + r
        eph = eph + h
        epl = epl + 1
        eacc = eacc + dx
        racc = racc + dx * epr
        hacc = hacc + dx * eph
        lacc = lacc + dx * epl.to(torch.float32)
        idx = torch.where(timeout, torch.full_like(nxt, tables.reset_idx), nxt)
        t = torch.where(done, torch.zeros_like(t1), t1)
        epr = torch.where(done, torch.zeros_like(epr), epr)
        eph = torch.where(done, torch.zeros_like(eph), eph)
        epl = torch.where(done, torch.zeros_like(epl), epl)
    lanes = tuple(x[None] for x in (idx, t, epr, eph, epl))
    return (q,) + lanes + (step0 + T * N,) + tuple(x[None] for x in (eacc, racc, hacc, lacc))


@pytest.mark.parametrize("alias", ["shift", "island"])
@pytest.mark.parametrize("start", ["reset", "hot", "random"])
@pytest.mark.parametrize("N, T", [(64, 40), (33, 17), (70, 9), (256, 24)])
def test_kernel_model_matches_the_plain_version(alias, start, N, T):
    """Every output bitwise (the fixed-point sums are exact in any order);
    from the hot-cell start most lanes share one cell, and cells whose Q
    ties stay tied."""
    args = _inputs(alias, N, T, start, seed=N + T)
    got = kernel_model(*args)
    want = tk.tabq_reference(*args)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    if start == "random":
        assert float(want[7].sum()) > 0  # lanes timed out inside the chunk


@pytest.mark.parametrize("alias", ALIASES)
def test_packed_entries_fold_the_reset_into_the_successor(alias):
    tables = _trainer(alias, 1).tables
    pack = tk.packed_entries(tables)
    done = tables.done.view(-1) != 0
    assert torch.equal(pack[~done, 0], tables.next.view(-1)[~done])
    assert bool((pack[done, 0] == tables.reset_idx).all())
    assert torch.equal(pack[:, 1].view(torch.float32), tables.reward.view(-1))
    assert torch.equal(pack[:, 2].view(torch.float32), tables.hidden.view(-1))
    assert torch.equal(pack[:, 3], done.to(torch.int32))


def _kernel_write(outs, S, A, N) -> torch.Tensor:
    """A buffer filled as ``tabq_launch`` fills it, through the addresses
    ``out_pointers`` hands it, from the outputs ``outs``."""
    buf = torch.zeros(tk.HEAD_WORDS + -(-(S * A) // 4) * 4 + 9 * N, dtype=torch.int32)
    for x, ptr in zip(outs, tk.out_pointers(buf, S, A, N)):
        at = (ptr - buf.data_ptr()) // 4
        words = x.reshape(-1).view(torch.int32)
        buf[at:at + words.numel()] = words
    return buf


@pytest.mark.parametrize("alias, N, T", [("shift", 64, 17), ("island", 33, 5),
                                         ("shift", 3, 0)])
def test_carved_outputs_carry_the_plain_outputs(alias, N, T):
    args = _inputs(alias, N, T, "random")
    plain = tk.tabq(*args)
    S, A = args[0].shape
    buf, outs = tk.carve_outputs(S, A, N, "cpu")
    written = _kernel_write(plain, S, A, N)
    assert buf.dtype == torch.int32 and buf.numel() == written.numel()
    buf.copy_(written)
    assert len(outs) == len(plain) == 11
    for i, (got, want) in enumerate(zip(outs, plain)):
        assert got.dtype == want.dtype and got.shape == want.shape, i
        assert got.is_contiguous() and torch.equal(got, want), i


@pytest.mark.parametrize("S, A, N", [(63, 4, 64), (1296, 4, 4096), (5, 3, 1), (7, 3, 33)])
def test_carved_views_tile_the_buffer_and_are_aligned(S, A, N):
    buf, outs = tk.carve_outputs(S, A, N, "cpu")
    base = buf.data_ptr()
    spans = sorted(((x.data_ptr() - base) // 4,
                    (x.data_ptr() - base) // 4 + x.numel() * x.element_size() // 4)
                   for x in outs)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[0] == (0, 2) and spans[1][0] == tk.HEAD_WORDS and spans[-1][1] == buf.numel()
    assert base % 16 == 0 and outs[0].data_ptr() - base == 16  # Q, 16-byte aligned
    assert (outs[6].data_ptr() - base) % 8 == 0  # the int64 step
    ptrs = tk.out_pointers(buf, S, A, N)
    assert list(ptrs) == [x.data_ptr() for x in outs]


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize("N, T", [(64, 128), (4096, 8192), (33, 17), (4096, 1)])
def test_shared_memory_fits_for_every_deterministic_alias(alias, N, T):
    """Q, its sums and counts and the packed table fit one block's 227 KB
    (32 bytes a cell: sokoban's 5184 cells take 166 KB), and beside them the
    deepest draw tiles that fit: 32 steps at the CLI's N = 64, 3 at
    N = 4096 on the small aliases, 1 on sokoban."""
    S, A = _trainer(alias, 1).tables.shape
    ts = tk.tile_steps(S, A, N, T)
    assert tk.base_bytes(S, A) == (32 * S * A + tk.EPS_BYTES
                                   + (-(8 * S * A) % 16) + 2 * (-(4 * S * A) % 16))
    assert tk.smem_bytes(S, A, N, T) <= SMEM_CAP
    assert 1 <= ts <= min(tk.MAX_TILE, T)
    assert tk.base_bytes(S, A) + 16 * N * (ts + 1) > SMEM_CAP or ts == min(tk.MAX_TILE, T)
    if N == 64:
        assert ts == min(32, T)
    if N == 4096 and T > 1:
        assert ts == (1 if alias == "sokoban" else 3)


def test_smem_check_states_the_size():
    """A table that leaves no room for one step of draws is refused with
    the bytes it needs."""
    S, A = 6000, 4
    tables = Tables(torch.zeros((S, A), dtype=torch.int32), torch.zeros((S, A)),
                    torch.zeros((S, A)), torch.zeros((S, A), dtype=torch.uint8), 100, 0)
    assert tk.tile_steps(S, A, 64, 128) == 0
    need = tk.base_bytes(S, A) + 16 * 64
    assert need > SMEM_CAP
    with pytest.raises(ValueError, match=f"need {need} bytes"):
        tk.check_smem(need, tables)


def _tables_on(tables, device):
    return Tables(*(x.to(device) for x in (tables.next, tables.reward, tables.hidden,
                                           tables.done)), tables.max_steps, tables.reset_idx)


def test_wrapper_still_raises_on_every_wrong_input():
    tables, hyper, q, state, step0, rand_a, u = _inputs("shift", 33, 17, "random")
    st = list(state)
    bad = [("rand_a: expected \\[T, N\\]", (tables, hyper, q, state, step0, rand_a[0], u)),
           ("lanes", (tables, hyper, q, state, step0, torch.zeros((1, 4097), dtype=torch.int32),
                      u)),
           ("tables: expected", (_tables_on(tables, "meta"), hyper, q, state, step0, rand_a, u)),
           ("q: expected", (tables, hyper, q.double(), state, step0, rand_a, u)),
           ("q: expected", (tables, hyper, q[:-1], state, step0, rand_a, u)),
           ("state: expected 5", (tables, hyper, q, state[:4], step0, rand_a, u)),
           ("state.idx", (tables, hyper, q, (st[0][:, :-1],) + tuple(st[1:]), step0, rand_a,
                          u)),
           ("step0", (tables, hyper, q, state, step0.to(torch.int32), rand_a, u)),
           ("step0", (tables, hyper, q, state, step0.reshape(()), rand_a, u)),
           ("rand_a", (tables, hyper, q, state, step0, rand_a.to(torch.int64), u)),
           ("u: expected", (tables, hyper, q, state, step0, rand_a, u.double())),
           ("u: expected", (tables, hyper, q, state, step0, rand_a, u[:, :-1]))]
    for i, name in enumerate(("idx", "t", "ep_return", "ep_hidden", "ep_len")):
        wrong = st[:i] + [st[i].to(torch.float64)] + st[i + 1:]
        bad.append((f"state.{name}", (tables, hyper, q, tuple(wrong), step0, rand_a, u)))
    for match, args in bad:
        with pytest.raises(ValueError, match=match):
            tk.tabq(*args)
    meta = _tables_on(tables, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.tabq(meta, hyper, q.to("meta"), tuple(x.to("meta") for x in state),
                step0.to("meta"), rand_a.to("meta"), u.to("meta"))


@pytest.mark.parametrize("name", sorted(lc.B2_CASES))
def test_b2_cases_have_their_shapes(name):
    alias, N, T = lc.B2_CASES[name]
    args = lc.tabq_case(name, CPU, torch.Generator().manual_seed(0))
    assert args[5].shape == args[6].shape == (T, N)
    assert all(x.shape == (1, N) for x in args[3]) and not bool(args[2].any())
    hot = lc.tabq_case(name, CPU, torch.Generator().manual_seed(0), hot=True)
    assert len(hot[3][0].unique()) == 1 and int(hot[4][0]) == 15_000


def test_ab_cases_hold_b2_to_each_own_plain_version():
    """The A/B tool's B2 cases against a second copy of this package (on the
    CPU both run the plain version): the new result must equal this
    package's plain version bitwise, the parent's may part from its own by
    less than atol 1e-4 in Q; anything else raises."""
    lc.load_package(Path(tk.__file__).parents[2], "sga_ab_self")
    cases = abl._ab_cases(CPU, torch.Generator().manual_seed(0), "sga_ab_self", ("b2",))
    assert sorted(cases) == sorted([f"b2 {k}" for k in lc.B2_CASES] + ["b2 shift wide hot"])
    calls, check, small = cases["b2 shift cli"]
    outs = {label: fn() for label, fn in calls.items()}
    assert small and "new bitwise equal" in check(outs)
    good = dict(outs)
    outs["parent"] = (good["parent"][0] + 5e-5,) + good["parent"][1:]
    check(outs)
    outs["parent"] = (good["parent"][0] + 1e-3,) + good["parent"][1:]
    with pytest.raises(AssertionError, match="Q parent vs its plain version"):
        check(outs)
    outs["parent"] = good["parent"][:1] + (good["parent"][1] + 1,) + good["parent"][2:]
    with pytest.raises(AssertionError, match="parent's kernel differs"):
        check(outs)
    outs = dict(good, new=(good["new"][0] + 5e-5,) + good["new"][1:])
    with pytest.raises(AssertionError, match="new kernel differs"):
        check(outs)


def test_b2_variants_still_match_the_source(tmp_path):
    """The variant tool's changes are text substitutions of the kernel's
    source; each still matches it and each changes it."""
    from safe_grid_agents_torch.tools import b2_variants as b2v
    from safe_grid_agents_torch.ops import _build
    paths = b2v.variant_sources(tmp_path)
    assert list(paths) == list(b2v.VARIANTS)
    texts = [p.read_text() for p in paths.values()]
    assert texts[0] == (_build.CSRC / "tabular_kernel.cu").read_text()
    assert len(set(texts)) == len(texts)
    assert [c[1] for c in b2v.CASES] == ["shift cli", "shift cli", "shift wide", "shift wide"]
