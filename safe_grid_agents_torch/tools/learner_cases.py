"""The learner kernels' (B4, B6), the tabular kernels' (B2, B8), the
stochastic PPO and DQN collects' (B10, B9), the DQN and PPO collects' (B3,
B5) and the actor-critic forward's (B11) inputs at the main path's shapes,
B4's check update by update (``check_b4_per_update``) and the draw on which
its long end-to-end check parts (``b4_wide_shared_draw``), a loader for a
second copy of the package, and CUDA-event timing, shared by the A/B, trace
and whisky tools and by ``chip_smoke.py``.

``load_package(root, alias)`` imports ``<root>/safe_grid_agents_torch`` (for
example the parent commit's tree, unpacked with ``git archive`` into the
git-ignored ``_archive/``) under the module name ``alias``, so its wrappers
and its ``csrc`` build beside this package's own; its kernels build into
its own ``_build/``.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

from ..agents import make_agent
from ..agents.tabular import TabularQAgent
from ..agents.dqn import DQNAgent
from ..agents.ppo import PPOAgent, ravel
from ..cli.parsing import agent_kwargs, prepare_parser
from ..envs import make_env
from ..envs.vec import StochTables, VecEnv
from ..ops.dqn_kernel import CollectHyper
from ..training import FusedDQNTrainer, FusedPPOTrainer, FusedTabularQTrainer
from ..types import map_fields

# The whisky deep-q and absent ppo-mlp commands of chip_smoke.py.
DQN_WHISKY = [
    "whisky", "deep-q", "--compiled", "--mxu", "--fused-kernel",
    "--n-envs", "128", "--steps", "61440", "--chunk-steps", "32",
    "--batch-size", "128", "--replay-capacity", "50000", "--sync-every", "100",
    "--warmup-steps", "32", "--updates-per-chunk", "32", "--lr", "0.0005",
    "--epsilon-anneal-steps", "60000", "--eval-steps", "60",
]
PPO_ABSENT = [
    "absent", "ppo-mlp", "--compiled", "--mxu", "--table-net", "--fused-kernel",
    "--n-envs", "1024", "--chunk-steps", "32", "--steps", "5000000", "--lr", "0.001",
    "--entropy-bonus", "0.05", "--chunks-per-dispatch", "16", "--seed", "1",
]


def load_package(root, alias: str):
    """Import ``<root>/safe_grid_agents_torch`` as the package ``alias``."""
    if alias in sys.modules:
        return sys.modules[alias]
    pkg = Path(root).resolve() / "safe_grid_agents_torch"
    if not (pkg / "__init__.py").exists():
        raise FileNotFoundError(f"no safe_grid_agents_torch package under {root}")
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def variant_ops(alias: str):
    """The variant's ``(dqn_update module, ppo_kernel module)``."""
    return (importlib.import_module(f"{alias}.ops.dqn_update_kernel"),
            importlib.import_module(f"{alias}.ops.ppo_kernel"))


def variant_module(alias: str, name: str):
    """The variant's ``ops.<name>`` module."""
    return importlib.import_module(f"{alias}.ops.{name}")


def variant_stoch_ops(alias: str):
    """The variant's ``(tabular_stoch_kernel module, ppo_stoch_collect_kernel
    module)``."""
    return (importlib.import_module(f"{alias}.ops.tabular_stoch_kernel"),
            importlib.import_module(f"{alias}.ops.ppo_stoch_collect_kernel"))


def cli_trainer(argv, dev):
    """The fused trainer the CLI builds for ``argv``."""
    args = prepare_parser().parse_args(argv)
    cenv = make_env(args.env, compiled=True, device=dev)
    agent = make_agent(args.agent, cenv, **agent_kwargs(args))
    if args.agent == "deep-q":
        return FusedDQNTrainer(agent, VecEnv(cenv, args.n_envs),
                               updates_per_chunk=args.updates_per_chunk), args
    return FusedPPOTrainer(agent, VecEnv(cenv, args.n_envs)), args


def dqn_case(name: str, dev, g: torch.Generator, updates=None, **agent_kw):
    """``(agent, args)`` for ``dqn_update(agent, *args)``: a warmed-up
    replay ring and a ``[U, B]`` batch drawn from it. ``name`` is
    ``sokoban`` (the table net of the sokoban command, U=32, B=128),
    ``wide`` (the same net at U=256, B=512), ``whisky`` (the whisky
    command's MLP agent, U=32, B=128) or ``ragged`` (an MLP of hidden
    100 × 60 on sokoban, U=8, B=100, sync_every=3: widths that a cluster of
    8 does not divide, the last block owning fewer units, and a batch that
    is no multiple of 8) or ``ragged_wide`` (the same net at B=600, which
    needs a cluster of 16: 7 and 4 units a block, the last block owning
    none, and a short last row tile); ``hidden512`` and ``batch4096`` are
    the sokoban command's MLP at ``--n-hidden 512`` (B=128) and at
    ``--batch-size 4096`` (width 128), which only the grid route takes, at
    U=32; ``ragged_grid`` is an MLP of hidden 300 × 300 on absent (D=245)
    at U=8, B=1000 (no tile edge falls on a multiple of 64, odd D), and
    ``sync_grid`` hidden 512 with double-Q at U=8, B=128, sync_every=5 (the
    target sync falls inside the chunk). ``updates`` overrides U."""
    if name == "whisky":
        tr, _ = cli_trainer(DQN_WHISKY, dev)
        U, B = tr.updates_per_chunk, tr.agent.batch_size
    else:
        cenv = make_env("absent" if name == "ragged_grid" else "sokoban", compiled=True,
                        device=dev)
        kw = dict(lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                  replay_capacity=50_000, sync_every=100, table=True, n_step=3)
        U, B = {"sokoban": (32, 128), "wide": (256, 512), "ragged": (8, 100),
                "ragged_wide": (8, 600), "hidden512": (32, 128), "batch4096": (32, 4096),
                "ragged_grid": (8, 1000), "sync_grid": (8, 128)}[name]
        if name == "ragged_grid":
            kw.update(table=False, hidden=(300, 300), batch_size=B)
        elif name.startswith("ragged"):
            kw.update(table=False, hidden=(100, 60), batch_size=B, sync_every=3)
        elif name in ("hidden512", "batch4096", "sync_grid"):
            kw.update(table=False, hidden=(128, 128) if name == "batch4096" else (512, 512),
                      batch_size=B)
            if name == "sync_grid":
                kw.update(double_q=True, sync_every=5)
        kw.update(agent_kw)
        tr = FusedDQNTrainer(DQNAgent(cenv, **kw), VecEnv(cenv, 128), updates_per_chunk=U)
    U = updates or U
    st, vs = tr.init(generator=g)
    st = tr.warmup_chunk(st, vs, g, 64)[0]
    idxs = torch.randint(0, st.buffer.size, (U, B), generator=g, device=dev)
    batch = map_fields(lambda x: x[idxs], st.buffer.storage)
    return tr.agent, (st.params, st.target_params, st.mu, st.nu, st.count.reshape(1),
                      st.updates.reshape(1), batch)


def ppo_case(name: str, dev, g: torch.Generator, updates=None, fresh=False):
    """``(agent, args)`` for ``ppo_optimize(agent, *args)`` with a fresh
    optimizer, ``ce`` 0.25 and random streams over the reachable states.
    ``island``: the island preset's net, 16 updates of 16,384 rows;
    ``absent``: the absent command's agent, 16 of 8192; ``ragged``:
    island's net, 4 updates of 16,700 rows (261 row tiles, the last of 60
    rows: no multiple of a row tile, and a stripe of two tiles that the
    last block fills half); ``island256``: the island preset's net at
    ``--n-hidden 256``, which only the wide route takes, 16 updates of
    16,384 rows; ``ragged256`` the same net at 4 updates of 16,700 rows (a
    ragged last tile); ``actions8`` island's 128-wide net with 8 actions
    (the env's table read as if it had 8), 4 updates of 4,100 rows;
    ``wide1813`` the net at hidden 1813, 2 updates of 1,000 rows from an
    optimizer one plain update in (``fresh``: from a fresh one).
    ``updates`` overrides U."""
    if name == "absent":
        tr, _ = cli_trainer(PPO_ABSENT, dev)
        U, B = 16, 8192
    else:
        cenv = make_env("island", compiled=True, device=dev)
        if name == "actions8":
            cenv = copy.copy(cenv)
            cenv.n_actions = 8
        hidden = {"island256": 256, "ragged256": 256, "wide1813": 1813}.get(name, 128)
        agent = PPOAgent(cenv, net="table", lr=5e-4, entropy_bonus=0.5, entropy_final=0.0,
                         entropy_anneal_steps=3_000_000, hidden=(hidden, hidden))
        # The fused trainer packs at most 7 actions; the optimize takes any.
        tr = None if name == "actions8" else FusedPPOTrainer(agent, VecEnv(cenv, 1024))
        U, B = {"ragged": (4, 16700), "ragged256": (4, 16700), "actions8": (4, 4100),
                "wide1813": (2, 1000)}.get(name, (16, 16384))
    agent = agent if tr is None else tr.agent
    U = updates or U
    reach = agent.env.reachable
    streams = (reach[torch.randint(0, len(reach), (U, B), generator=g, device=dev)]
               .to(torch.int32),
               torch.randint(0, agent.env.n_actions, (U, B), dtype=torch.int32, generator=g,
                             device=dev),
               torch.log(torch.rand((U, B), generator=g, device=dev) * 0.5 + 0.1),
               torch.randn((U, B), generator=g, device=dev),
               10 * torch.randn((U, B), generator=g, device=dev))
    a0 = agent.init(device=dev, seed=4) if tr is None else tr.init(seed=4, generator=g)[0]
    ce = torch.tensor([0.25], device=dev)
    state = (ravel(a0.params), a0.mu, a0.nu, a0.count.reshape(1))
    if name == "wide1813" and not fresh:
        # Adam's moments from one plain update on other rows first. From a
        # fresh optimizer Adam's first step divides every gradient element by
        # |g| + ε, and at 3.8 M parameters the plain version on the card and
        # on the CPU already differ there beyond the tolerance (PERF.md, PR 9).
        from ..ops.ppo_kernel import ppo_optimize_reference
        other = tuple(t[:1].flip(1)[:, :256].contiguous() for t in streams)
        state = ppo_optimize_reference(agent, *state, ce, other)[:4]
    return agent, (*state, ce, streams)


# B8 cases: alias, N, T; B10 cases: alias, compile kwargs, N, T. The CLI
# shapes of the tabular-q and ppo-mlp commands and the full widths.
B8_CASES = {"absent cli": ("absent", 64, 128), "tomato cli": ("tomato", 64, 128),
            "whisky cli": ("whisky", 64, 128), "absent wide": ("absent", 4096, 8192),
            "tomato wide": ("tomato", 4096, 8192)}
B10_CASES = {"absent main": ("absent", {}, 1024, 32),
             "absent wide": ("absent", {}, 4096, 1024),
             "whisky wide": ("whisky", {}, 4096, 1024),
             "tomato wide": ("tomato", {}, 4096, 1024),
             "friend@127 wide": ("friend", {"cap": 127}, 4096, 1024)}


def tabq_stoch_case(name: str, dev, g: torch.Generator, hot: bool = False):
    """``(tables, hyper, q, state, step0, rand_a, u, bits, stumble, rand2)``
    for ``tabq_stoch`` at ``B8_CASES[name]``: zero Q and lanes from a reset,
    as a chunk of the trainer starts, and step 0 (ε = 1, then annealing over
    40,000 steps). ``hot`` puts every lane on the first reset state and
    starts late in the anneal (step 35,000, ε ≈ 0.17), so that most lanes
    share one (s, a) cell."""
    alias, N, T = B8_CASES[name]
    cenv = make_env(alias, compiled=True, device=dev)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=40_000),
                              VecEnv(cenv, N))
    state = tr.init(g)[1]
    step0 = torch.zeros(1, dtype=torch.int64, device=dev)
    if hot:
        state = (torch.full((1, N), tr.tables.r0, dtype=torch.int32, device=dev),) + tuple(
            torch.zeros_like(x) for x in state[1:])
        step0 = torch.tensor([35_000], dtype=torch.int64, device=dev)
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g, device=dev)
    u = torch.rand((T, N), generator=g, device=dev)
    return (tr.tables, tr.hyper, torch.zeros(tr.S, tr.A, device=dev), state, step0, rand_a,
            u) + tr.vec.draw_mechanics(g, T)


def ppo_stoch_case(name: str, dev, g: torch.Generator):
    """``(tables, rows, state, u, bits, stumble, rand_a)`` for
    ``ppo_stoch_collect`` at ``B10_CASES[name]``: the policy rows of a
    randomly initialised table net (lr 1e-3, entropy bonus 0.05, as the
    absent command's) and lanes from a reset."""
    alias, kw, N, T = B10_CASES[name]
    cenv = make_env(alias, compiled=True, device=dev, **kw)
    tr = FusedPPOTrainer(PPOAgent(cenv, net="table", lr=1e-3, entropy_bonus=0.05),
                         VecEnv(cenv, N))
    astate, vstate = tr.init(seed=3, generator=g)
    state = tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                    vstate.ep_hidden, vstate.ep_len))
    return (tr.tables, tr.policy_rows(astate.params), state,
            torch.rand((T, N), generator=g, device=dev)) + tr.vec.draw_mechanics(g, T)


# B2 cases: alias, N, T (the shift preset's chunk, and full width).
B2_CASES = {"shift cli": ("shift", 64, 128), "shift wide": ("shift", 4096, 8192)}


def tabq_case(name: str, dev, g: torch.Generator, hot: bool = False):
    """``(tables, hyper, q, state, step0, rand_a, u)`` for ``tabq`` at
    ``B2_CASES[name]``: the shift preset's agent (lr 0.2, ε annealing over
    20,000 steps), zero Q and lanes from a reset, as a chunk of the trainer
    starts, at step 0 (ε = 1). ``hot`` starts late in the anneal (step
    15,000, ε ≈ 0.26), so that most lanes take the greedy action of zero Q
    at the reset state: one (s, a) cell."""
    alias, N, T = B2_CASES[name]
    cenv = make_env(alias, compiled=True, device=dev)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000),
                              VecEnv(cenv, N))
    state = tr.init()[1]
    step0 = torch.tensor([15_000 if hot else 0], dtype=torch.int64, device=dev)
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g, device=dev)
    u = torch.rand((T, N), generator=g, device=dev)
    return (tr.tables, tr.hyper, torch.zeros(tr.S, tr.A, device=dev), state, step0, rand_a,
            u)


# The card checks' edge cases of B1 (alias, N, T) and B2 (alias, N, T,
# start): full width, a partial warp with a partial tile, one lane, no
# steps, the largest table (sokoban, with one-step draw tiles for B2 at
# N = 4096); for B2 a random Q, the hot-cell start and lanes that time out
# inside the chunk (tests/test_torch_kernels_gpu.py and
# chip_smoke.py's phases 2 and 3).
B1_EDGES = (("shift", 4096, 4096), ("sokoban", 4096, 4096), ("shift-test", 4096, 17),
            ("shift", 33, 17), ("sokoban", 33, 17), ("island", 33, 17),
            ("shift-test", 1, 4096), ("shift", 1, 17), ("sokoban", 33, 0), ("shift", 4096, 0))
B2_EDGES = (("shift", 64, 128, "hot"), ("shift", 64, 128, "random"),
            ("shift", 64, 1, "timeout"), ("shift", 33, 17, "random"),
            ("shift", 33, 17, "hot"), ("island", 33, 128, "timeout"),
            ("shift", 4096, 1, "random"), ("shift", 4096, 17, "hot"),
            ("shift", 4096, 128, "timeout"), ("sokoban", 4096, 17, "hot"),
            ("sokoban", 64, 128, "random"))


def random_lanes(cenv, n: int, dev, g: torch.Generator) -> tuple:
    """``n`` lanes in the middle of their episodes: reachable states,
    random times, sums and lengths."""
    reach = cenv.reachable
    return (reach[torch.randint(0, len(reach), (1, n), generator=g, device=dev)]
            .to(torch.int32),
            torch.randint(0, cenv.max_steps, (1, n), dtype=torch.int32, generator=g,
                          device=dev),
            torch.randint(-30, 5, (1, n), generator=g, device=dev).to(torch.float32),
            torch.randint(-30, 5, (1, n), generator=g, device=dev).to(torch.float32),
            torch.randint(0, 60, (1, n), dtype=torch.int32, generator=g, device=dev))


def tabq_edge_case(alias: str, n: int, T: int, start: str, dev, g: torch.Generator):
    """``(tables, hyper, q, state, step0, rand_a, u)`` for ``tabq`` (the
    shift preset's agent): ``random`` a random Q and random lanes on
    reachable states, ``hot`` zero Q with every lane on the reset state
    late in the ε anneal (most lanes on one (s, a)), ``timeout`` a random
    Q with the lanes 1-10 steps from the time limit."""
    cenv = make_env(alias, compiled=True, device=dev)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000),
                              VecEnv(cenv, n))
    if start == "hot":
        q, state = torch.zeros(tr.S, tr.A, device=dev), tr.init()[1]
        step0 = torch.tensor([15_000], dtype=torch.int64, device=dev)
    else:
        q = torch.randn(tr.S, tr.A, generator=g, device=dev)
        state = random_lanes(cenv, n, dev, g)
        if start == "timeout":
            state = (state[0], torch.randint(cenv.max_steps - 10, cenv.max_steps, (1, n),
                                             dtype=torch.int32, generator=g, device=dev),
                     *state[2:])
        step0 = torch.tensor([5_000], dtype=torch.int64, device=dev)
    rand_a = torch.randint(0, tr.A, (T, n), dtype=torch.int32, generator=g, device=dev)
    u = torch.rand((T, n), generator=g, device=dev)
    return tr.tables, tr.hyper, q, state, step0, rand_a, u


# B3 cases: alias, N, T (the sokoban DQN command's chunk, and full width).
B3_CASES = {"sokoban main": ("sokoban", 128, 32), "sokoban wide": ("sokoban", 4096, 4096)}


def dqn_collect_case(name: str, dev, g: torch.Generator):
    """``(tables, hyper, greedy, state, step0, rand_a, u)`` for
    ``dqn_collect`` at ``B3_CASES[name]``: the sokoban command's agent (ε
    annealing over 60,000 steps), the greedy row of its freshly initialised
    Q-net, lanes from a reset and the global step at 20,000 (inside the
    anneal)."""
    alias, N, T = B3_CASES[name]
    cenv = make_env(alias, compiled=True, device=dev)
    agent = DQNAgent(cenv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                     replay_capacity=50_000, sync_every=100, table=True, n_step=3)
    tr = FusedDQNTrainer(agent, VecEnv(cenv, N), updates_per_chunk=32)
    astate, state = tr.init(generator=g)
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g, device=dev)
    u = torch.rand((T, N), generator=g, device=dev)
    step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
    return tr.tables, tr.hyper, tr.greedy_row(astate.params), state, step0, rand_a, u


# B9 cases: alias, compile kwargs, N, T (the whisky deep-q command's chunk,
# and full width on four aliases, friend's tables in device memory at cap
# 127).
B9_CASES = {"whisky main": ("whisky", {}, 128, 32),
            "absent wide": ("absent", {}, 4096, 4096),
            "whisky wide": ("whisky", {}, 4096, 4096),
            "tomato wide": ("tomato", {}, 4096, 4096),
            "friend@127 wide": ("friend", {"cap": 127}, 4096, 4096)}
# The card checks' edge cases of B9 (alias, compile kwargs, N, T, start): a
# partial last tile under deeper tiles (T = 32, 80 and 144 under 128-step
# tiles, 48 under friend at cap 15's 32-step tiles), partial and
# single-lane blocks (N = 33, 1, 4097), the tables and the greedy row in
# device memory (cap 127, T = 80 under its 128-step tiles), and no steps at
# all. ``synthetic_stoch_case`` adds tiles of exactly 16 steps.
B9_EDGES = (("whisky", {}, 128, 32, "reset"), ("whisky", {}, 33, 32, "mid-episode"),
            ("absent", {}, 33, 144, "mid-episode"), ("tomato", {}, 1, 80, "mid-episode"),
            ("interrupt", {}, 4097, 48, "reset"), ("friend", {"cap": 15}, 33, 48, "mid-episode"),
            ("friend", {"cap": 127}, 33, 80, "mid-episode"), ("absent", {}, 128, 0, "reset"))


def dqn_stoch_collect_case(name: str, dev, g: torch.Generator, greedy: str = "net",
                           start: str = "reset", shape=None):
    """``(tables, hyper, greedy, state, step0, rand_a, u, bits, stumble,
    rand2)`` for ``dqn_stoch_collect`` at ``B9_CASES[name]`` (or at
    ``shape``, an ``(alias, compile kwargs, N, T)``): the whisky command's
    hyperparameters (ε annealing over 60,000 steps, the 2×128 MLP), the
    global step at 20,000 (inside the anneal), the greedy row of the freshly
    initialised Q-net (``greedy="random"``: a random row, every action
    taken) and lanes from a reset (``start="mid-episode"``:
    ``random_lanes``)."""
    alias, kw, N, T = shape or B9_CASES[name]
    cenv = make_env(alias, compiled=True, device=dev, **kw)
    agent = DQNAgent(cenv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                     replay_capacity=50_000, sync_every=100)
    tr = FusedDQNTrainer(agent, VecEnv(cenv, N), updates_per_chunk=32)
    astate, state = tr.init(generator=g)
    row = (tr.greedy_row(astate.params) if greedy == "net" else
           torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g, device=dev))
    if start == "mid-episode":
        state = random_lanes(cenv, N, dev, g)
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g, device=dev)
    u = torch.rand((T, N), generator=g, device=dev)
    step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
    return (tr.tables, tr.hyper, row, state, step0, rand_a, u) + tr.vec.draw_mechanics(g, T)


# B9 on random tables (S, N, T): the tables in shared memory only beside
# 16-step tiles (a depth no alias takes), and 3.4 times friend's states at
# cap 127 in device memory.
B9_SYNTHETIC = ((2400, 33, 48), (60_000, 4096, 256))


def synthetic_stoch_case(S: int, N: int, T: int, dev, g: torch.Generator):
    """``dqn_stoch_collect``'s inputs on random carried-reset tables (mode
    2) of ``S`` states and 4 actions, ~5% of them terminal, with a time
    limit of 100 and a random greedy row: at S = 2,400 the tables and the
    greedy row fit in shared memory beside 16-step tiles and no deeper
    ones, at S = 60,000 neither the tables nor the greedy row fit."""
    A = 4

    def states():
        return torch.randint(0, S, (S, A), dtype=torch.int32, generator=g, device=dev)

    tables = StochTables(
        next=states(), reward=torch.randint(-3, 4, (S, A), generator=g, device=dev).float(),
        hidden=torch.randn((S, A), generator=g, device=dev),
        done=(torch.rand((S, A), generator=g, device=dev) < 0.05).to(torch.uint8),
        cand0=states(), cand1=states(), drunk=None, max_steps=100, mode=2, r0=0, r1=0,
        dry_nbits=0)
    state = (torch.randint(0, S, (1, N), dtype=torch.int32, generator=g, device=dev),
             torch.randint(0, 100, (1, N), dtype=torch.int32, generator=g, device=dev),
             torch.zeros((1, N), device=dev), torch.zeros((1, N), device=dev),
             torch.zeros((1, N), dtype=torch.int32, device=dev))
    hyper = CollectHyper(epsilon=1.0, epsilon_final=0.1, anneal=60_000.0, use_hidden=False)
    bits = (torch.rand((T, N), generator=g, device=dev) < 0.5).to(torch.int32)
    zeros = torch.zeros((T, N), dtype=torch.int32, device=dev)
    return (tables, hyper,
            torch.randint(0, A, (S,), dtype=torch.int32, generator=g, device=dev), state,
            torch.tensor([20_000], dtype=torch.int64, device=dev),
            torch.randint(0, A, (T, N), dtype=torch.int32, generator=g, device=dev),
            torch.rand((T, N), generator=g, device=dev), bits, zeros, zeros)


# B5 cases: alias, N, T (the island preset's chunk, sokoban at full width, and
# a partial warp with a partial tile). B11 cases: rows (the MXU PPO trainer's
# per-step collect forward and its update forward).
B5_CASES = {"island main": ("island", 1024, 64), "sokoban wide": ("sokoban", 4096, 1024),
            "island edge": ("island", 33, 17)}
B11_CASES = {"collect": 1024, "update": 16384}


def ppo_collect_case(name: str, dev, g: torch.Generator):
    """``(tables, rows, state, u)`` for ``ppo_collect`` at ``B5_CASES[name]``:
    the policy rows of a randomly initialised table net (the island
    preset's hyperparameters) and lanes from a reset."""
    alias, N, T = B5_CASES[name]
    cenv = make_env(alias, compiled=True, device=dev)
    tr = FusedPPOTrainer(PPOAgent(cenv, net="table", lr=5e-4, entropy_bonus=0.5),
                         VecEnv(cenv, N))
    astate, vstate = tr.init(seed=3)
    state = tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                    vstate.ep_hidden, vstate.ep_len))
    return (tr.tables, tr.policy_rows(astate.params), state,
            torch.rand((T, N), generator=g, device=dev))


def fused_mlp_case(B: int, dev, g: torch.Generator):
    """``(x, w1, b1, w2, b2, wh, bh)`` for ``fused_mlp_forward``: island's
    ``PPOAgent(net="pallas")`` net (D = 288, 4 actions) at its flax
    initialisation, and ``B`` rows of observation planes (each cell on with
    probability 0.1)."""
    from ..ops.fused_mlp import PallasActorCriticMLP
    params = PallasActorCriticMLP(288, 4).init_params(torch.Generator().manual_seed(5), dev)
    x = (torch.rand((B, 288), generator=g, device=dev) < 0.1).to(torch.float32)
    return (x,) + tuple(params[k] for k in ("w1", "b1", "w2", "b2", "wh", "bh"))


def event_ms(call):
    """``(ms, result)`` of one call, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


SPIN_CYCLES = 4_000_000  # ~2 ms of a spin kernel at the H100's clock


def fenced_ms(call, reps: int = 5) -> float:
    """Median device ms per call from CUDA events, with the host's launch
    path hidden: a spin kernel (``torch.cuda._sleep``) queued first keeps
    the device busy while the host records the start event, runs the
    wrapper and records the end event, so the events time the device work
    alone (the kernel, and any gaps between kernels of one call). It needs
    the launch path shorter than the spin, ~2 ms."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def outputs_equal(a, b) -> bool:
    """Bitwise equality of two wrapper results (tensors, dicts of tensors)."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(outputs_equal(a[k], b[k]) for k in a)
    if dataclasses.is_dataclass(a):
        return all(outputs_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return all(outputs_equal(x, y) for x, y in zip(a, b))


def flat_tensors(x) -> list:
    """The tensors of a wrapper result (tensors, dicts of tensors, tuples),
    in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in x for t in flat_tensors(x[k])]
    return [t for y in x for t in flat_tensors(y)]


def check_b4(outs, ref) -> float:
    """Holds a ``dqn_update`` result against the plain version's: params,
    target, μ and ν to rtol 2e-4 / atol 1e-6, counters equal, the loss to
    rtol 2e-5; returns the largest absolute difference."""
    err = 0.0
    for got, want in zip(outs[:4], ref[:4]):
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=1e-6)
            err = max(err, float((got[k] - want[k]).abs().max()))
    for a, b in zip(outs[4:6], ref[4:6]):
        if not torch.equal(a, b):
            raise AssertionError(f"dqn_update counters {a.tolist()} != {b.tolist()}")
    torch.testing.assert_close(outs[6], ref[6], rtol=2e-5, atol=0.0)
    return max(err, float((outs[6] - ref[6]).abs().max()))


def check_b4_per_update(agent, args) -> dict:
    """B4's long check update by update: each of the batch's U updates
    starts from the plain version's state after the updates before it, and
    the kernel's single update from that state is held to the plain
    version's single update (``check_b4``: rtol 2e-4 / atol 1e-6, the loss
    to rtol 2e-5). A check over U updates from one start compounds two
    summation orders U times, and on some draws the two trajectories part
    beyond the tolerance although every update stays within it (PERF.md);
    this check holds each update to it. Returns the largest error and U."""
    from ..ops.dqn_update_kernel import dqn_update, dqn_update_reference
    state, batch = args[:6], args[6]
    U = batch.action.shape[0]
    err = 0.0
    for i in range(U):
        one = map_fields(lambda x: x[i:i + 1].contiguous(), batch)
        ref = dqn_update_reference(agent, *state, one)
        try:
            err = max(err, check_b4(dqn_update(agent, *state, one), ref))
        except AssertionError as e:
            raise AssertionError(f"B4 update {i} of {U}: {e}") from None
        state = ref[:6]
    return {"updates": U, "max_abs_err": err}


def b4_beyond(outs, ref) -> dict:
    """Entries of a ``dqn_update`` result beyond the parameter tolerance
    (rtol 2e-4 / atol 1e-6), by tensor, with the largest difference."""
    out = {}
    for i, (got, want) in enumerate(zip(outs[:4], ref[:4])):
        for k in want:
            d = (got[k] - want[k]).abs()
            out[f"{i}.{k}"] = (int((d > 1e-6 + 2e-4 * want[k].abs()).sum()), want[k].numel(),
                               float(d.max()))
    return out


def b4_wide_shared_draw(dev):
    """``(agent, args)`` of B4's ``wide`` case (sokoban's table net, 256
    updates of 512 rows from a fresh optimizer) on the draws on which its
    end-to-end check parts: the draws ``chip_smoke.py``'s phase 3c takes
    when every shape of its phases 2-3b (B1, B2, B3) draws from the one
    generator of seed 0, as it did before its edge shapes of B3 got their
    own. The draws of those phases are replayed here in their order, with
    their shapes (a CUDA generator's position depends only on what was
    drawn), then phase 3c's cases up to ``wide``."""
    from ..ops.rollout_kernel import RolloutEngine
    g = torch.Generator(device=dev).manual_seed(0)

    def mid_episode(cenv, n):
        reach = cenv.reachable
        torch.randint(0, len(reach), (1, n), generator=g, device=dev)
        torch.randint(0, cenv.max_steps, (1, n), dtype=torch.int32, generator=g, device=dev)
        torch.randint(-30, 5, (1, n), generator=g, device=dev)
        torch.randint(-30, 5, (1, n), generator=g, device=dev)
        torch.randint(0, 60, (1, n), dtype=torch.int32, generator=g, device=dev)

    n_full = 4096
    for alias in ("shift", "shift-test"):  # phase 2: B1
        eng = RolloutEngine(make_env(alias, compiled=True, device=dev), n_full)
        for start in ("reset", "mid-episode"):
            if start == "mid-episode":
                mid_episode(eng.cenv, n_full)
            torch.randint(0, eng.A, (1024, n_full), dtype=torch.int32, generator=g, device=dev)
    shift = make_env("shift", compiled=True, device=dev)  # phase 3: B2
    S, A = shift.num_states, shift.n_actions
    torch.randn(S, A, generator=g, device=dev)
    mid_episode(shift, n_full)
    for T, n in ((1, n_full), (256, n_full), (128, 64)):
        torch.randint(0, A, (T, n), dtype=torch.int32, generator=g, device=dev)
        torch.rand((T, n), generator=g, device=dev)
    sokoban = make_env("sokoban", compiled=True, device=dev)  # phase 3b: B3
    for n, T in ((n_full, 1024), (128, 32), (33, 17), (33, 0)):
        for start in ("reset", "mid-episode"):
            if start == "mid-episode":
                mid_episode(sokoban, n)
            torch.randint(0, sokoban.n_actions, (sokoban.num_states,), dtype=torch.int32,
                          generator=g, device=dev)
            torch.randint(0, sokoban.n_actions, (T, n), dtype=torch.int32, generator=g,
                          device=dev)
            torch.rand((T, n), generator=g, device=dev)
    hyper = dict(lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                 replay_capacity=50_000, sync_every=3, n_step=3)
    for table, double_q in ((True, False), (False, False), (True, True)):  # phase 3c
        tr = FusedDQNTrainer(DQNAgent(sokoban, **hyper, table=table, double_q=double_q),
                             VecEnv(sokoban, 128), updates_per_chunk=32)
        astate, vstate = tr.init(generator=g)
        astate = tr.warmup_chunk(astate, vstate, g, 64)[0]
        torch.randint(0, astate.buffer.size, (8, 128), generator=g, device=dev)
    tr, _ = cli_trainer(DQN_WHISKY, dev)
    astate, vstate = tr.init(generator=g)
    astate = tr.warmup_chunk(astate, vstate, g, 64)[0]
    torch.randint(0, astate.buffer.size, (tr.updates_per_chunk, tr.agent.batch_size),
                  generator=g, device=dev)
    for name in ("ragged", "ragged_wide"):
        dqn_case(name, dev, g)
    return dqn_case("wide", dev, g)


def check_b6(outs, ref) -> float:
    """Holds a ``ppo_optimize`` result against the plain version's: params
    to rtol 2e-4 / atol 2e-6, μ to rtol 2e-4 / atol 1e-6, ν to rtol 2e-4,
    the count equal, the loss to rtol 2e-5 / atol 1e-6; returns the largest
    absolute difference."""
    torch.testing.assert_close(outs[0], ref[0], rtol=2e-4, atol=2e-6)
    torch.testing.assert_close(outs[1], ref[1], rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(outs[2], ref[2], rtol=2e-4, atol=1e-9)
    if not torch.equal(outs[3], ref[3]):
        raise AssertionError(f"ppo_optimize count {outs[3].tolist()} != {ref[3].tolist()}")
    torch.testing.assert_close(outs[4], ref[4], rtol=2e-5, atol=1e-6)
    return max(float((a - b).abs().max()) for a, b in zip(outs[:3] + outs[4:], ref[:3] + ref[4:]))
