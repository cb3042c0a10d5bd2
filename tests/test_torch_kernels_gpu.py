"""Card-only legs: each CUDA kernel against its plain PyTorch version.

Marked ``gpu``; the ``cuda`` fixture skips them where no card is visible.
They import no JAX, so on the machine with the card they run with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: B1, B3, B5, B7, B9 and B10 are exact (bitwise), in both table
placements of B1, B2, B3 and B5. B2 and B8 sum
their TD errors in exact 64-bit fixed point, so they are bitwise (also on
hot cells, where a warp's lanes share one (s, a)), inside the reference's Q
tolerance of atol 1e-4; B1, B2 and B9's edge cases are also launched twice, bitwise
equal. B4 (both routes) sums its
gradients in another order than autograd's matmuls: params, target, μ and ν
to rtol 2e-4 / atol 1e-6, the loss to rtol 2e-5 (the reference's own,
tests/test_dqn_update_kernel.py); B4 and B6 sum in fixed orders, so two
launches on the same inputs are bitwise equal. B6 sums its gradients in fixed orders
other than autograd's: params to rtol 2e-4 / atol 2e-6, μ to rtol 2e-4 /
atol 1e-6, the loss to rtol 2e-5 / atol 1e-6, the count equal
(tests/test_ppo_kernel.py), on both routes. B11: forward atol 1e-5, gradients rtol/atol
1e-3 (tests/test_ops.py).
"""
import dataclasses

import pytest
import torch

from safe_grid_agents_torch.agents.dqn import DQNAgent
from safe_grid_agents_torch.agents.ppo import PPOAgent, ravel
from safe_grid_agents_torch.agents.tabular import TabularQAgent
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.vec import VecEnv
from safe_grid_agents_torch.ops import dqn_kernel as dk
from safe_grid_agents_torch.ops import dqn_stoch_kernel as dsk
from safe_grid_agents_torch.ops import dqn_update_kernel as duk
from safe_grid_agents_torch.ops import fused_mlp as fm
from safe_grid_agents_torch.ops import ppo_collect_kernel as pck
from safe_grid_agents_torch.ops import ppo_kernel as pk
from safe_grid_agents_torch.ops import ppo_stoch_collect_kernel as psk
from safe_grid_agents_torch.ops import rollout_kernel as rk
from safe_grid_agents_torch.ops import stoch_rollout_kernel as srk
from safe_grid_agents_torch.ops import tabular_kernel as tk
from safe_grid_agents_torch.ops import tabular_stoch_kernel as tsk
from safe_grid_agents_torch.tools import ab_learners as abl
from safe_grid_agents_torch.tools import learner_cases as lc
from safe_grid_agents_torch.training import (
    FusedDQNTrainer, FusedPPOTrainer, FusedTabularQTrainer, stats_to_host,
)
from safe_grid_agents_torch.types import map_fields

pytestmark = pytest.mark.gpu
N = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _mid_episode(cenv, g, dev, n=N):
    """A seeded random lane state on reachable indices."""
    reach = cenv.reachable
    pick = torch.randint(0, len(reach), (1, n), generator=g, device=dev)
    return (
        reach[pick].to(torch.int32),
        torch.randint(0, cenv.max_steps, (1, n), dtype=torch.int32, generator=g, device=dev),
        torch.randint(-30, 5, (1, n), generator=g, device=dev).to(torch.float32),
        torch.randint(-30, 5, (1, n), generator=g, device=dev).to(torch.float32),
        torch.randint(0, 60, (1, n), dtype=torch.int32, generator=g, device=dev),
    )


@pytest.mark.parametrize("alias", ["shift", "shift-test"])
@pytest.mark.parametrize("start", ["reset", "mid-episode"])
def test_rollout_kernel_matches_plain(cuda, alias, start):
    eng = rk.RolloutEngine(make_env(alias, compiled=True, device=cuda), N)
    g = torch.Generator(device=cuda).manual_seed(0)
    state = eng.reset() if start == "reset" else _mid_episode(eng.cenv, g, cuda)
    actions = torch.randint(0, eng.A, (1024, N), dtype=torch.int32, generator=g, device=cuda)
    launches = rk.counts.launches
    outs = eng.run_actions(state, actions)
    torch.cuda.synchronize()
    assert rk.counts.launches == launches + 1
    ref = rk.rollout_reference(eng.tables, state, actions)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("alias, n, T", lc.B1_EDGES)
@pytest.mark.parametrize("start", ["reset", "mid-episode"])
def test_rollout_kernel_edges_match_plain(cuda, alias, n, T, start):
    """Bitwise against the plain version, and two launches bitwise equal."""
    eng = rk.RolloutEngine(make_env(alias, compiled=True, device=cuda), n)
    g = torch.Generator(device=cuda).manual_seed(n + T)
    state = eng.reset() if start == "reset" else _mid_episode(eng.cenv, g, cuda, n)
    actions = torch.randint(0, eng.A, (T, n), dtype=torch.int32, generator=g, device=cuda)
    launches = rk.counts.launches
    outs = eng.run_actions(state, actions)
    again = eng.run_actions(state, actions)
    torch.cuda.synchronize()
    assert rk.counts.launches == launches + 2
    ref = rk.rollout_reference(eng.tables, state, actions)
    for i, (a, b, c) in enumerate(zip(outs, again, ref)):
        assert torch.equal(a, c) and torch.equal(a, b), i


@pytest.mark.parametrize("alias", ["shift", "shift-test", "island", "sokoban"])
def test_rollout_smem_mirror_matches_the_kernel(cuda, alias):
    S, A = VecEnv(make_env(alias, compiled=True, device=cuda), 1).tables.shape
    assert rk.kernel_smem_bytes(S, A) == rk.smem_bytes(S, A)


def _stoch_env(alias, dev):
    name, _, cap = alias.partition("@")
    kw = {"cap": int(cap)} if cap else {}
    return make_env(name, compiled=True, device=dev, **kw)


# (N, T) of the collect and rollout legs: the DQN command's chunk, a partial
# warp with a partial tile, no steps at all, and full width.
SHAPES = {"main": (128, 32), "edge": (33, 17), "empty": (33, 0), "wide": (N, 1024)}
STOCH_PLACES = [("absent", "shared"), ("interrupt", "shared"), ("whisky", "shared"),
                ("tomato", "shared"), ("friend@15", "shared"), ("friend@127", "global")]


@pytest.mark.parametrize("alias,place", STOCH_PLACES)
@pytest.mark.parametrize("start", ["reset", "mid-episode"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stoch_rollout_kernel_matches_plain(cuda, alias, place, start, shape):
    """B7 in every mode (coin, carried, noise, drying) and both table
    placements (friend's tables fit beside the stream tiles at cap 15 and
    outgrow shared memory at cap 127), at every shape of ``SHAPES``,
    bitwise."""
    n, T = SHAPES[shape]
    eng = srk.StochRolloutEngine(_stoch_env(alias, cuda), n)
    assert srk.rollout_placement(eng.tables) == place
    g = torch.Generator(device=cuda).manual_seed(7)
    state = eng.reset(g) if start == "reset" else _mid_episode(eng.cenv, g, cuda, n)
    streams = eng.draw_streams(g, T)
    launches = srk.counts.launches
    outs = eng.run_streams(state, *streams)
    torch.cuda.synchronize()
    assert srk.counts.launches == launches + 1
    ref = srk.stoch_rollout_reference(eng.tables, state, *streams)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    if shape == "wide":
        assert float(outs[6].sum()) > n


@pytest.mark.parametrize("alias,place", STOCH_PLACES)
def test_stoch_rollout_smem_mirror_matches_the_kernel(cuda, alias, place):
    """The wrapper's mirror of B7's shared-memory layout equals the built
    kernel's, with the tables staged and without."""
    tables = srk.StochRolloutEngine(_stoch_env(alias, cuda), 1).tables
    for staged in (True, False):
        assert srk.kernel_smem_bytes(tables, staged) == srk.smem_bytes(tables, staged)


@pytest.mark.parametrize("alias,place", [
    ("absent", "shared"), ("whisky", "shared"), ("tomato", "shared"), ("friend@15", "global"),
])
@pytest.mark.parametrize("case", ["one-step-random-q", "256-steps-zero-q"])
def test_tabular_stoch_kernel_matches_plain(cuda, alias, place, case):
    """B8, bitwise; at cap 15 friend's tables no longer fit beside Q in
    shared memory."""
    cenv = _stoch_env(alias, cuda)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=40_000),
                              VecEnv(cenv, N))
    assert srk.placement(tr.tables, tsk.smem_bytes(tr.S, tr.A)) == place
    g = torch.Generator(device=cuda).manual_seed(8)
    if case == "one-step-random-q":
        T = 1
        q = torch.randn(tr.S, tr.A, generator=g, device=cuda)
        state = _mid_episode(cenv, g, cuda)
    else:
        T = 256
        q = torch.zeros(tr.S, tr.A, device=cuda)
        state = tr.init(g)[1]
    step0 = torch.tensor([1_000], dtype=torch.int64, device=cuda)
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g, device=cuda)
    u = torch.rand((T, N), generator=g, device=cuda)
    streams = (rand_a, u) + tr.vec.draw_mechanics(g, T)
    launches = tsk.counts.launches
    outs = tsk.tabq_stoch(tr.tables, tr.hyper, q, state, step0, *streams)
    torch.cuda.synchronize()
    assert tsk.counts.launches == launches + 1
    ref = tsk.tabq_stoch_reference(tr.tables, tr.hyper, q, state, step0, *streams)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


def test_tabular_stoch_kernel_hot_cells(cuda):
    """B8 on hot-cell traffic, bitwise: N = 4096 lanes all on tomato's reset
    state late in the ε anneal, so most lanes of every warp share one (s, a)
    cell (the warp-aggregated atomics), for T = 256 steps."""
    g = torch.Generator(device=cuda).manual_seed(9)
    args = list(lc.tabq_stoch_case("tomato wide", cuda, g, hot=True))
    args[5:] = [x[:256] for x in args[5:]]
    launches = tsk.counts.launches
    outs = tsk.tabq_stoch(*args)
    torch.cuda.synchronize()
    assert tsk.counts.launches == launches + 1
    ref = tsk.tabq_stoch_reference(*args)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    assert float(outs[7].sum()) > 0


def test_fused_trainer_learns_tomato_on_card(cuda):
    cenv = make_env("tomato", compiled=True, device=cuda)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=40_000),
                              VecEnv(cenv, 64))
    g = torch.Generator(device=cuda).manual_seed(1)
    astate, vstate = tr.init(g)
    launches, plain = tsk.counts.launches, tsk.counts.plain_calls
    for _ in range(16):
        astate, vstate, _ = tr.train_chunk(astate, vstate, g, 128)
    assert tsk.counts.launches == launches + 16 and tsk.counts.plain_calls == plain
    _, es = tr.eval_chunk(astate, tr.vec.reset(g), 120, generator=g)
    s = stats_to_host(es)
    assert s["mean_return"] > 100.0 and s["mean_hidden"] < s["mean_return"] - 50.0, s


@pytest.mark.parametrize("case", ["one-step-random-q", "256-steps-zero-q"])
def test_tabular_kernel_matches_plain(cuda, case):
    cenv = make_env("shift", compiled=True, device=cuda)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000),
                              VecEnv(cenv, N))
    g = torch.Generator(device=cuda).manual_seed(1)
    if case == "one-step-random-q":
        T = 1
        q = torch.randn(tr.S, tr.A, generator=g, device=cuda)
        state = _mid_episode(cenv, g, cuda)
    else:
        T = 256
        q = torch.zeros(tr.S, tr.A, device=cuda)
        state = tr.init()[1]
    step0 = torch.tensor([1_000], dtype=torch.int64, device=cuda)
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g, device=cuda)
    u = torch.rand((T, N), generator=g, device=cuda)
    outs = tk.tabq(tr.tables, tr.hyper, q, state, step0, rand_a, u)
    torch.cuda.synchronize()
    ref = tk.tabq_reference(tr.tables, tr.hyper, q, state, step0, rand_a, u)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("alias, n, T, start", lc.B2_EDGES)
def test_tabular_kernel_edges_match_plain(cuda, alias, n, T, start):
    """Bitwise against the plain version, and two launches bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(n + T)
    args = lc.tabq_edge_case(alias, n, T, start, cuda, g)
    launches = tk.counts.launches
    outs = tk.tabq(*args)
    again = tk.tabq(*args)
    torch.cuda.synchronize()
    assert tk.counts.launches == launches + 2
    ref = tk.tabq_reference(*args)
    for i, (a, b, c) in enumerate(zip(outs, again, ref)):
        assert torch.equal(a, c) and torch.equal(a, b), i
    if start == "timeout":
        assert float(ref[7].sum()) > 0


@pytest.mark.parametrize("alias", ["shift", "island", "sokoban"])
@pytest.mark.parametrize("n, T", [(64, 128), (33, 17), (4096, 8192), (4096, 1)])
def test_tabular_layout_mirror_matches_the_kernel(cuda, alias, n, T):
    S, A = VecEnv(make_env(alias, compiled=True, device=cuda), 1).tables.shape
    assert tk.kernel_layout(S, A, n, T) == (tk.smem_bytes(S, A, n, T),
                                            tk.tile_steps(S, A, n, T))


def test_fused_trainer_learns_shift_on_card(cuda):
    cenv = make_env("shift", compiled=True, device=cuda)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000),
                              VecEnv(cenv, 64))
    astate, vstate = tr.init()
    g = torch.Generator(device=cuda).manual_seed(1)
    launches, plain = tk.counts.launches, tk.counts.plain_calls
    for _ in range(8):
        astate, vstate, _ = tr.train_chunk(astate, vstate, g, 128)
    assert tk.counts.launches == launches + 8 and tk.counts.plain_calls == plain
    _, es = tr.eval_chunk(astate, tr.vec.reset(), 30)
    assert stats_to_host(es)["mean_return"] > 38.0


def _dqn_trainer(dev, n, **kw):
    cenv = make_env("sokoban", compiled=True, device=dev)
    agent = DQNAgent(cenv, **{**dict(lr=5e-4, epsilon=0.6, epsilon_anneal_steps=60_000,
                                     batch_size=128, replay_capacity=50_000,
                                     sync_every=100), **kw})
    return FusedDQNTrainer(agent, VecEnv(cenv, n), updates_per_chunk=32)


@pytest.mark.parametrize("start", ["reset", "mid-episode"])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("cheat", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_dqn_collect_kernel_matches_plain(cuda, start, warm, cheat, shape):
    """B3 with ε annealing and pinned to 1 (warmup), recording the observed
    or (``--cheat``) the hidden reward, at every shape of ``SHAPES``,
    bitwise."""
    n, T = SHAPES[shape]
    tr = _dqn_trainer(cuda, n)
    g = torch.Generator(device=cuda).manual_seed(2)
    astate, state = tr.init()
    if start == "mid-episode":
        state = _mid_episode(tr.vec.cenv, g, cuda, n)
    greedy = torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g, device=cuda)
    rand_a = torch.randint(0, tr.A, (T, n), dtype=torch.int32, generator=g, device=cuda)
    u = torch.rand((T, n), generator=g, device=cuda)
    step0 = torch.tensor([40_000], dtype=torch.int64, device=cuda)
    hyper = dataclasses.replace(tr.hyper.warmup() if warm else tr.hyper, use_hidden=cheat)
    launches = dk.counts.launches
    outs = dk.dqn_collect(tr.tables, hyper, greedy, state, step0, rand_a, u)
    torch.cuda.synchronize()
    assert dk.counts.launches == launches + 1
    ref = dk.dqn_collect_reference(tr.tables, hyper, greedy, state, step0, rand_a, u)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("alias", ["shift", "island", "sokoban"])
def test_dqn_collect_smem_mirror_matches_the_kernel(cuda, alias):
    S, A = VecEnv(make_env(alias, compiled=True, device=cuda), 1).tables.shape
    assert dk.kernel_smem_bytes(S, A) == dk.smem_bytes(S, A)


@pytest.mark.parametrize("table,double_q", [(True, False), (False, False), (True, True)])
def test_dqn_update_kernel_matches_plain(cuda, table, double_q):
    tr = _dqn_trainer(cuda, 128, table=table, double_q=double_q, sync_every=3, n_step=3)
    g = torch.Generator(device=cuda).manual_seed(3)
    astate, vstate = tr.init()
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 64)
    idxs = torch.randint(0, astate.buffer.size, (8, 128), generator=g, device=cuda)
    batch = map_fields(lambda x: x[idxs], astate.buffer.storage)
    args = (astate.params, astate.target_params, astate.mu, astate.nu,
            astate.count.reshape(1), astate.updates.reshape(1))
    for _ in range(2):  # from a fresh state, then from one with counts 8 and 8
        launches = duk.counts.launches
        outs = duk.dqn_update(tr.agent, *args, batch)
        torch.cuda.synchronize()
        assert duk.counts.launches == launches + 1
        ref = duk.dqn_update_reference(tr.agent, *args, batch)
        for got, want in zip(outs[:4], ref[:4]):
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=1e-6)
        assert torch.equal(outs[4], ref[4]) and torch.equal(outs[5], ref[5])
        torch.testing.assert_close(outs[6], ref[6], rtol=2e-5, atol=0.0)
        args = ref[:6]


def test_dqn_update_kernel_matches_plain_on_whisky(cuda):
    """B4 at the shape the whisky deep-q command gives it: the MLP net on
    whisky's 128 states, B=128, U=32, sync_every=100."""
    cenv = make_env("whisky", compiled=True, device=cuda)
    agent = DQNAgent(cenv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                     replay_capacity=50_000, sync_every=100)
    tr = FusedDQNTrainer(agent, VecEnv(cenv, 128), updates_per_chunk=32)
    g = torch.Generator(device=cuda).manual_seed(3)
    astate, vstate = tr.init(generator=g)
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 64)
    idxs = torch.randint(0, astate.buffer.size, (32, 128), generator=g, device=cuda)
    batch = map_fields(lambda x: x[idxs], astate.buffer.storage)
    args = (astate.params, astate.target_params, astate.mu, astate.nu,
            astate.count.reshape(1), astate.updates.reshape(1))
    for _ in range(2):  # from a fresh state, then from one with counts 32 and 32
        launches = duk.counts.launches
        outs = duk.dqn_update(tr.agent, *args, batch)
        torch.cuda.synchronize()
        assert duk.counts.launches == launches + 1
        ref = duk.dqn_update_reference(tr.agent, *args, batch)
        for got, want in zip(outs[:4], ref[:4]):
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=1e-6)
        assert torch.equal(outs[4], ref[4]) and torch.equal(outs[5], ref[5])
        torch.testing.assert_close(outs[6], ref[6], rtol=2e-5, atol=0.0)
        args = ref[:6]


@pytest.mark.parametrize("name", sorted(abl.B4_CHECKS))
def test_dqn_update_kernel_cluster_cases(cuda, name):
    """B4's cluster design on the main path's shapes (a cluster of 8), on
    the wide U = 256, B = 512 (16), and on widths no cluster size divides
    (hidden 100 × 60) at B = 100 (8) and B = 600 (16, the last block owning
    no unit): the geometry mirror equals the built kernel's, two launches on
    the same inputs are bitwise equal, and both meet the plain version's
    tolerances."""
    launches = duk.counts.launches
    abl.check_b4_case(name, cuda, torch.Generator(device=cuda).manual_seed(7))
    assert duk.counts.launches == launches + 2


@pytest.mark.parametrize("name", abl.B6_CHECKS)
def test_ppo_optimize_kernel_cases(cuda, name):
    """B6's persistent design at island's and absent's shapes and on 16,700
    rows (a ragged last tile and a half-filled last stripe): geometry
    mirror, bitwise reproducibility and the plain version's tolerances."""
    launches = pk.counts.launches
    abl.check_b6_case(name, cuda, torch.Generator(device=cuda).manual_seed(7))
    assert pk.counts.launches == launches + 2


@pytest.mark.parametrize("name", abl.B4_GRID_CHECKS)
def test_dqn_update_kernel_block_cases(cuda, name):
    """B4's grid route at the shapes no cluster holds: sokoban's MLP at
    hidden 512 and at B = 4096 (U = 32), hidden 300 × 300 on absent (D = 245)
    at B = 1000, hidden 512 with double-Q and a target sync inside the
    chunk: geometry mirror, bitwise reproducibility and the plain version's
    tolerances; only the grid route launches."""
    launches, cluster = duk.grid_counts.launches, duk.counts.launches
    abl.check_b4_case(name, cuda, torch.Generator(device=cuda).manual_seed(7))
    assert duk.grid_counts.launches == launches + 2 and duk.counts.launches == cluster


@pytest.mark.parametrize("name", abl.B6_WIDE_CHECKS)
def test_ppo_optimize_kernel_wide_cases(cuda, name):
    """B6's wide route on island's net at hidden 256 (16 × 16,384 rows, and
    4 × 16,700: a ragged last tile), with 8 actions and at hidden 1813:
    geometry mirror, bitwise reproducibility and the plain version's
    tolerances; only the wide route launches."""
    launches, persistent = pk.wide_counts.launches, pk.counts.launches
    abl.check_b6_case(name, cuda, torch.Generator(device=cuda).manual_seed(7))
    assert pk.wide_counts.launches == launches + 2 and pk.counts.launches == persistent


def test_fused_dqn_trainer_learns_sokoban_on_card(cuda):
    tr = _dqn_trainer(cuda, 128, epsilon=1.0)
    astate, vstate = tr.init()
    g = torch.Generator(device=cuda).manual_seed(2)
    plain = (dk.counts.plain_calls, duk.counts.plain_calls)
    launches = (dk.counts.launches, duk.counts.launches)
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 32)
    best = -1e9
    for i in range(15):
        astate, vstate, _, loss = tr.train_chunk(astate, vstate, g, 32)
        if i >= 8:
            _, es = tr.eval_chunk(astate, tr.vec.reset(), 60)
            best = max(best, stats_to_host(es)["mean_return"])
    assert (dk.counts.plain_calls, duk.counts.plain_calls) == plain
    assert (dk.counts.launches - launches[0], duk.counts.launches - launches[1]) == (16, 15)
    assert best >= 40.0, best


def _ppo_trainer(dev, alias, n, **kw):
    cenv = make_env(alias, compiled=True, device=dev)
    agent = PPOAgent(cenv, net="table", **{**dict(lr=5e-4, entropy_bonus=0.5), **kw})
    return FusedPPOTrainer(agent, VecEnv(cenv, n))


# The island preset's chunk, sokoban (tables and rows 109 KB of shared
# memory), a partial warp with a partial tile, and no steps at all.
@pytest.mark.parametrize("alias,n,T", [("island", 1024, 64), ("sokoban", 4096, 256),
                                       ("island", 33, 17), ("island", 33, 0)])
@pytest.mark.parametrize("start", ["reset", "mid-episode"])
def test_ppo_collect_kernel_matches_plain(cuda, alias, n, T, start):
    tr = _ppo_trainer(cuda, alias, n)
    g = torch.Generator(device=cuda).manual_seed(4)
    astate, vstate = tr.init(seed=1)
    state = tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                    vstate.ep_hidden, vstate.ep_len))
    if start == "mid-episode":
        state = _mid_episode(tr.vec.cenv, g, cuda, n)
    rows = tr.policy_rows(astate.params)
    u = torch.rand((T, n), generator=g, device=cuda)
    launches = pck.counts.launches
    outs = pck.ppo_collect(tr.tables, rows, state, u)
    torch.cuda.synchronize()
    assert pck.counts.launches == launches + 1
    ref = pck.ppo_collect_reference(tr.tables, rows, state, u)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("alias", ["island", "sokoban"])
def test_ppo_collect_smem_mirror_matches_the_kernel(cuda, alias):
    tr = _ppo_trainer(cuda, alias, 32)
    assert pck.kernel_smem_bytes(tr.S, tr.A) == pck.smem_bytes(tr.S, tr.A)


def _ppo_streams(tr, g, U, B):
    dev = tr.device
    reach = tr.vec.cenv.reachable
    return (reach[torch.randint(0, len(reach), (U, B), generator=g, device=dev)].to(torch.int32),
            torch.randint(0, tr.A, (U, B), dtype=torch.int32, generator=g, device=dev),
            torch.log(torch.rand((U, B), generator=g, device=dev) * 0.5 + 0.1),
            torch.randn((U, B), generator=g, device=dev),
            10 * torch.randn((U, B), generator=g, device=dev))


@pytest.mark.parametrize("U,B", [(16, 16384), (8, 1000)])
def test_ppo_optimize_kernel_matches_plain(cuda, U, B):
    tr = _ppo_trainer(cuda, "island", 1024)
    g = torch.Generator(device=cuda).manual_seed(5)
    astate, _ = tr.init(seed=2)
    streams = _ppo_streams(tr, g, U, B)
    args = (ravel(astate.params), astate.mu, astate.nu, astate.count.reshape(1))
    for rnd in range(2):  # from a fresh optimizer, then from the result
        ce = torch.tensor([0.4 - 0.2 * rnd], device=cuda)
        launches = pk.counts.launches
        outs = pk.ppo_optimize(tr.agent, *args, ce, streams)
        torch.cuda.synchronize()
        assert pk.counts.launches == launches + 1
        ref = pk.ppo_optimize_reference(tr.agent, *args, ce, streams)
        torch.testing.assert_close(outs[0], ref[0], rtol=2e-4, atol=2e-6)
        torch.testing.assert_close(outs[1], ref[1], rtol=2e-4, atol=1e-6)
        assert torch.equal(outs[3], ref[3])
        torch.testing.assert_close(outs[4], ref[4], rtol=2e-5, atol=1e-6)
        args = ref[:4]


def test_ppo_optimize_kernel_matches_plain_on_absent(cuda):
    """B6 at the shape the absent ppo-mlp command gives it: absent's 98
    states, 16 updates of 8192 rows (N = 1024, T = 32)."""
    tr = _ppo_trainer(cuda, "absent", 1024, lr=1e-3, entropy_bonus=0.05)
    g = torch.Generator(device=cuda).manual_seed(5)
    astate, _ = tr.init(seed=2, generator=g)
    streams = _ppo_streams(tr, g, 16, 8192)
    args = (ravel(astate.params), astate.mu, astate.nu, astate.count.reshape(1))
    for rnd in range(2):  # from a fresh optimizer, then from the result
        ce = torch.tensor([0.05 - 0.02 * rnd], device=cuda)
        launches = pk.counts.launches
        outs = pk.ppo_optimize(tr.agent, *args, ce, streams)
        torch.cuda.synchronize()
        assert pk.counts.launches == launches + 1
        ref = pk.ppo_optimize_reference(tr.agent, *args, ce, streams)
        torch.testing.assert_close(outs[0], ref[0], rtol=2e-4, atol=2e-6)
        torch.testing.assert_close(outs[1], ref[1], rtol=2e-4, atol=1e-6)
        assert torch.equal(outs[3], ref[3])
        torch.testing.assert_close(outs[4], ref[4], rtol=2e-5, atol=1e-6)
        args = ref[:4]


def _offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte boundary
    (the kernel's 4-byte copies)."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.view(t.shape).copy_(t)


# Island's width (D = 288) at every row tile; an odd width with a partial
# last k-tile at every row tile (D = 245, absent's, a 5 x 7 x 7 observation);
# x, and the weights, 4 bytes off 16-byte alignment.
@pytest.mark.parametrize("B,obs,offset", [
    *((B, (4, 8, 9), None) for B in (1, 33, 100, 1024, 16384)),
    *((B, (5, 7, 7), None) for B in (33, 1024, 16384)),
    (1024, (4, 8, 9), "x"), (16384, (4, 8, 9), "x"), (1024, (4, 8, 9), "weights")])
def test_fused_mlp_kernel_matches_plain(cuda, B, obs, offset):
    g = torch.Generator(device=cuda).manual_seed(6)
    D = obs[0] * obs[1] * obs[2]
    net = fm.PallasActorCriticMLP(D, 4)
    params = net.init_params(torch.Generator().manual_seed(0), cuda)
    params = {k: v + 0.01 * torch.randn(v.shape, generator=g, device=cuda)
              for k, v in params.items()}
    if offset == "weights":
        params = {k: _offset(v) for k, v in params.items()}
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    x = (torch.rand((B, *obs), generator=g, device=cuda) < 0.2).to(torch.float32)
    if offset == "x":
        x = _offset(x)
    assert (x.data_ptr() % 16 != 0) == (offset == "x")
    assert (params["w1"].data_ptr() % 16 != 0) == (offset == "weights")
    launches = fm.counts.launches
    logits, value = net.apply(params, x)
    torch.cuda.synchronize()
    assert fm.counts.launches == launches + 1
    loss = (logits ** 2).sum() + (value ** 2).sum()
    grads = torch.autograd.grad(loss, list(params.values()))
    xf = x.reshape(B, -1)
    out, _, _ = fm.fused_mlp_reference(xf, *(params[k] for k in ("w1", "b1", "w2", "b2",
                                                                  "wh", "bh")))
    rl, rv = out[:, :4], out[:, 4]
    torch.testing.assert_close(logits, rl, rtol=0.0, atol=1e-5)
    torch.testing.assert_close(value, rv, rtol=0.0, atol=1e-5)
    rgrads = torch.autograd.grad((rl ** 2).sum() + (rv ** 2).sum(), list(params.values()))
    for a, b in zip(grads, rgrads):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("B", [1, 33, 1024, 4096, 16384])
def test_fused_mlp_geometry_mirror_matches_the_kernel(cuda, B):
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    geo = fm.geometry(B, n_sm)
    assert fm.kernel_geometry(B, n_sm) == (geo.rows, geo.tiles, geo.grid, geo.smem_bytes)


def test_fused_ppo_trainer_learns_island_on_card(cuda):
    """The island preset (N = 1024, T = 64, lr 5e-4, entropy 0.5 annealed
    to 0 over 3 M steps) for its first 40 chunks: both kernels launch every
    chunk, no plain version runs, and the greedy eval after 2.6 M steps —
    before the anneal ends, where some seeds later collapse — is 45/45 on
    every seed tried on the card and on the CPU (PERF.md)."""
    tr = _ppo_trainer(cuda, "island", 1024, entropy_final=0.0, entropy_anneal_steps=3_000_000)
    astate, vstate = tr.init(seed=0)
    g = torch.Generator(device=cuda).manual_seed(0)
    plain = (pck.counts.plain_calls, pk.counts.plain_calls)
    launches = (pck.counts.launches, pk.counts.launches)
    for _ in range(40):
        astate, vstate, _, loss = tr.train_chunk(astate, vstate, g, 64)
    _, es = tr.eval_chunk(astate, tr.vec.reset(), 120)
    stats = stats_to_host(es)
    assert (pck.counts.plain_calls, pk.counts.plain_calls) == plain
    assert (pck.counts.launches - launches[0], pk.counts.launches - launches[1]) == (40, 40)
    assert bool(torch.isfinite(loss))
    assert stats["mean_return"] >= 40.0 and stats["mean_hidden"] >= 40.0, stats


# B9 and B10: every mode (coin, carried, noise, drying) and both placements.
# B9 keeps the tables and its int32 greedy row in shared memory up to
# friend at cap 15; B10's policy rows (32 bytes per state) push friend at
# cap 15 into device memory beside cap 127.
STOCH_COLLECT_CASES = [
    ("absent", "shared", "shared"), ("interrupt", "shared", "shared"),
    ("whisky", "shared", "shared"), ("tomato", "shared", "shared"),
    ("friend@15", "shared", "global"), ("friend@127", "global", "global"),
]


@pytest.mark.parametrize("alias,place,_", STOCH_COLLECT_CASES)
@pytest.mark.parametrize("start", ["reset", "mid-episode"])
def test_dqn_stoch_kernel_matches_plain(cuda, alias, place, _, start):
    cenv = _stoch_env(alias, cuda)
    tr = FusedDQNTrainer(DQNAgent(cenv, epsilon=0.6, epsilon_anneal_steps=60_000),
                         VecEnv(cenv, N))
    assert srk.placement(tr.tables, tr.S) == place
    g = torch.Generator(device=cuda).manual_seed(9)
    state = tr.init(generator=g)[1] if start == "reset" else _mid_episode(cenv, g, cuda)
    greedy = torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g, device=cuda)
    rand_a = torch.randint(0, tr.A, (1024, N), dtype=torch.int32, generator=g, device=cuda)
    u = torch.rand((1024, N), generator=g, device=cuda)
    streams = (rand_a, u) + tr.vec.draw_mechanics(g, 1024)
    step0 = torch.tensor([40_000], dtype=torch.int64, device=cuda)
    # ε annealing, then pinned to 1 (warmup).
    for hyper in (tr.hyper, tr.hyper.warmup()):
        launches = dsk.counts.launches
        outs = dsk.dqn_stoch_collect(tr.tables, hyper, greedy, state, step0, *streams)
        torch.cuda.synchronize()
        assert dsk.counts.launches == launches + 1
        ref = dsk.dqn_stoch_collect_reference(tr.tables, hyper, greedy, state, step0, *streams)
        for a, b in zip(outs, ref):
            assert torch.equal(a, b)
        assert float(outs[6].sum()) > N


@pytest.mark.parametrize("alias,place,_", STOCH_COLLECT_CASES)
def test_dqn_stoch_geometry_mirror_matches_the_kernel(cuda, alias, place, _):
    """B9's placement, tile depth and shared memory as the built kernel
    picks them equal the wrapper's mirror; friend at cap 15 keeps its
    tables in shared memory under 32-step tiles, at cap 127 the tables and
    the greedy row stay in device memory."""
    tables = VecEnv(_stoch_env(alias, cuda), 1).tables
    assert dsk.kernel_geometry(tables) == dsk.layout(tables)
    assert (dsk.collect_placement(tables) == "shared") == (place == "shared")


@pytest.mark.parametrize("edge", lc.B9_EDGES, ids=lambda e: f"{e[0]}-N{e[2]}-T{e[3]}-{e[4]}")
def test_dqn_stoch_kernel_edges(cuda, edge):
    """B9 with a partial last tile under deeper tiles, partial blocks, the
    tables in device memory and no steps, from a random greedy row, with ε
    annealing and pinned to 1: launched twice, the two launches and the
    plain version bitwise equal."""
    alias, kw, n, T, start = edge
    g = torch.Generator(device=cuda).manual_seed(12)
    args = list(lc.dqn_stoch_collect_case(None, cuda, g, greedy="random", start=start,
                                          shape=(alias, kw, n, T)))
    for hyper in (args[1], args[1].warmup()):
        args[1] = hyper
        launches = dsk.counts.launches
        outs = dsk.dqn_stoch_collect(*args)
        again = dsk.dqn_stoch_collect(*args)
        torch.cuda.synchronize()
        assert dsk.counts.launches == launches + 2
        ref = dsk.dqn_stoch_collect_reference(*args)
        for a, b, c in zip(outs, again, ref):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert len({x.untyped_storage().data_ptr() for x in outs}) == 1


@pytest.mark.parametrize("S, n, T", lc.B9_SYNTHETIC)
def test_dqn_stoch_kernel_on_random_tables(cuda, S, n, T):
    """B9 on random carried-reset tables: at 2,400 states the tables fit in
    shared memory beside 16-step tiles only, at 60,000 the tables and the
    greedy row both stay in device memory; the built kernel's layout equals
    the mirror, two launches and the plain version bitwise equal."""
    args = lc.synthetic_stoch_case(S, n, T, cuda, torch.Generator(device=cuda).manual_seed(13))
    assert dsk.kernel_geometry(args[0]) == dsk.layout(args[0])
    assert dsk.layout(args[0])[:2] == (("shared", 16) if S == 2400 else ("global", 128))
    outs = dsk.dqn_stoch_collect(*args)
    again = dsk.dqn_stoch_collect(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(outs, again, dsk.dqn_stoch_collect_reference(*args)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert float(outs[6].sum()) > n


@pytest.mark.parametrize("alias,_,place", STOCH_COLLECT_CASES)
@pytest.mark.parametrize("start", ["reset", "mid-episode"])
def test_ppo_stoch_collect_kernel_matches_plain(cuda, alias, _, place, start):
    cenv = _stoch_env(alias, cuda)
    tr = FusedPPOTrainer(PPOAgent(cenv, net="table"), VecEnv(cenv, N))
    assert srk.placement(tr.tables, psk.smem_bytes(tr.S, tr.A)) == place
    g = torch.Generator(device=cuda).manual_seed(10)
    astate, vstate = tr.init(seed=1, generator=g)
    state = tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                    vstate.ep_hidden, vstate.ep_len))
    if start == "mid-episode":
        state = _mid_episode(cenv, g, cuda)
    rows = tr.policy_rows(astate.params)
    streams = (torch.rand((1024, N), generator=g, device=cuda),) + tr.vec.draw_mechanics(g, 1024)
    launches = psk.counts.launches
    outs = psk.ppo_stoch_collect(tr.tables, rows, state, *streams)
    torch.cuda.synchronize()
    assert psk.counts.launches == launches + 1
    ref = psk.ppo_stoch_collect_reference(tr.tables, rows, state, *streams)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    assert float(outs[5].sum()) > N


def test_ppo_stoch_collect_kernel_at_the_trainer_shape(cuda):
    """B10 at the absent ppo-mlp command's N = 1024, T = 32 (32 one-warp
    blocks, two stream tiles), bitwise; its 18 outputs are views of one
    buffer."""
    args = lc.ppo_stoch_case("absent main", cuda, torch.Generator(device=cuda).manual_seed(11))
    launches = psk.counts.launches
    outs = psk.ppo_stoch_collect(*args)
    torch.cuda.synchronize()
    assert psk.counts.launches == launches + 1
    ref = psk.ppo_stoch_collect_reference(*args)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    assert len({x.untyped_storage().data_ptr() for x in outs}) == 1


# ---- B1, B2, B3, B5 with their tables in device memory -----------------------------

@pytest.mark.parametrize("kernel", ["b1", "b2", "b3", "b5"])
def test_device_memory_placement_matches_plain(cuda, kernel):
    """``tools/placement_cases.py``'s cases of one kernel (conveyor in device
    memory from reset and mid-episode, N=33 x T=17, T=0; B1 also sokoban2;
    B1 and B2 also toy, boat and corners in shared memory): every case
    launched twice, bitwise equal, and bitwise the plain version's."""
    from safe_grid_agents_torch.tools import placement_cases as pc

    g = torch.Generator(device=cuda).manual_seed(3)
    {"b1": pc.check_b1, "b2": pc.check_b2, "b3": pc.check_b3, "b5": pc.check_b5}[kernel](
        cuda, g, log=lambda *a: None)


def test_placement_mirrors_match_the_kernels(cuda):
    from safe_grid_agents_torch.tools import placement_cases as pc

    got = pc.check_mirrors(cuda, log=lambda *a: None)
    assert got["conveyor"]["B1"] == got["sokoban2"]["B1"] == "global"
    assert got["sokoban"]["B1"] == got["sokoban"]["B2 N=4096"] == "shared"


# ---- the CNN's convolutions in float32 ----------------------------------------------

def test_cnn_on_the_card_matches_the_cpu(cuda):
    """The CNN of ``shift ppo-cnn --preset`` at the collect's 512 lanes and
    the optimize's 2048-row minibatch: forward within atol 1e-5, gradients
    within rtol/atol 1e-4 of the CPU (cuDNN's TF32 off; ``chip_smoke.py``
    phase 7 runs the same check)."""
    from safe_grid_agents_torch.tools import agent_gates

    errs = agent_gates.cnn_card_vs_cpu(cuda)
    assert set(errs) == {"rows_512", "rows_2048"}


@pytest.mark.parametrize("rows", [512, 2048])
def test_conv3x3_repeats_bitwise_on_the_card(cuda, rows):
    """``_Conv3x3``'s forward and backward (the input's, the kernel's and the
    bias's gradients) at the shapes of ``shift ppo-cnn --preset``'s two
    convolutions (the collect's 512 lanes, the optimize's 2048-row
    minibatch), twice on the same inputs: bitwise equal (cuDNN's
    deterministic algorithms, ``networks._fp32_convs``)."""
    from safe_grid_agents_torch.agents import networks

    cenv = make_env("shift", compiled=True, device="cpu")
    P, H, W = cenv.obs_shape
    g = torch.Generator().manual_seed(rows)
    pick = torch.randint(0, len(cenv.reachable), (rows,), generator=g)
    planes = cenv.obs_table[cenv.reachable[pick].long()].reshape(rows, P, H, W)
    for c_in, c_out, x in ((P, 32, planes), (32, 64, torch.rand(rows, 32, H, W, generator=g))):
        w = torch.randn(c_out, c_in, 3, 3, generator=g) / (3 * c_in ** 0.5)
        b = torch.randn(c_out, generator=g) * 0.1
        up = torch.randn(rows, c_out, H, W, generator=g)

        def run():
            leaves = [t.to(cuda).requires_grad_(True) for t in (x, w, b)]
            out = networks._Conv3x3.apply(*leaves)
            return [out.detach(), *torch.autograd.grad(out, leaves, up.to(cuda))]

        first, again = run(), run()
        for name, u, v in zip(("out", "grad x", "grad w", "grad b"), first, again):
            assert torch.equal(u, v), (c_in, c_out, name, float((u - v).abs().max()))


def test_tabular_learn_repeats_bitwise_on_the_card(cuda):
    """``TabularQAgent.learn`` on 4096 duplicate-heavy lanes (three states of
    shift) twice on the card: Q bitwise equal (its TD sums are exact 64-bit
    fixed point), and within atol 1e-6 of the CPU's."""
    import numpy as np

    from safe_grid_agents_torch.agents.tabular import TabularQState

    cenv = make_env("shift", compiled=True, device="cpu")
    rng = np.random.default_rng(9)
    reach = cenv.reachable.numpy()
    three = rng.choice(reach, 3, replace=False)
    q = torch.from_numpy(rng.normal(0.0, 1.0, (cenv.num_states, 4)).astype(np.float32))
    batch = [torch.from_numpy(x) for x in (
        rng.choice(three, N).astype(np.int32), rng.integers(0, 4, N).astype(np.int32),
        rng.normal(0.0, 10.0, N).astype(np.float32), rng.choice(reach, N).astype(np.int32),
        rng.random(N) < 0.2)]
    agent = TabularQAgent(cenv, lr=0.2)

    def learn(device):
        st = TabularQState(q=q.to(device), step=torch.zeros((), dtype=torch.int64,
                                                           device=device))
        return agent.learn(st, *(x.to(device) for x in batch)).q.cpu()

    first, again, cpu = learn(cuda), learn(cuda), learn("cpu")
    assert torch.equal(first, again), int((first != again).sum())
    torch.testing.assert_close(first, cpu, rtol=0.0, atol=1e-6)
