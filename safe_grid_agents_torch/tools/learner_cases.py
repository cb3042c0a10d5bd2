"""The learner kernels' (B4, B6), the stochastic tabular and PPO kernels'
(B8, B10), the PPO collect's (B5) and the actor-critic forward's (B11)
inputs at the main path's shapes, a loader for a second copy of the
package, and CUDA-event timing, shared by the A/B, trace and whisky tools
and by ``chip_smoke.py``.

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
from ..envs.vec import VecEnv
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
