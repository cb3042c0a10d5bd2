"""Experiment entry point — counterpart of ``safe_grid_agents_tpu/cli/main.py``.

parse → build env/agent/trainer → warmup → chunked train loop with periodic
greedy eval and metrics → final eval. The engine and trainer are picked as
the reference picks them:

    <alias> <agent> [--compiled]      the array engine (envs/array_vec.py)
        and the base trainers: random/single (DummyTrainer), tabular-q
        (TabularQTrainer; the friend family only without --compiled),
        deep-q (DQNTrainer, uniform or --prioritized), ppo-mlp and ppo-cnn
        (PPOTrainer), ppo-crmdp (CRMDPTrainer)
    <alias> tabular-q --compiled --mxu [--cheat]   MXUTabularQTrainer
    <alias> tabular-q --compiled --mxu --fused-kernel   (B2; B8 on the
        stochastic aliases)
    <alias> deep-q --compiled --mxu [--table-net] [--double-q] [--n-step n]
        [--prioritized [--per-*]] [--cheat] ...   (MXUDQNTrainer: the
        autograd update scan)
    <alias> deep-q --compiled --mxu --fused-kernel ...   (B3 or B9, then B4
        where it takes the net; under --prioritized, at other depths or with
        more than 8 actions, MXUDQNTrainer's update scan)
    <alias> ppo-mlp|ppo-cnn|ppo-crmdp --compiled --mxu [--mxu-parity]
        [--preset] ...   (the MXU trainers, fast or parity mode)
    <alias> ppo-mlp|ppo-crmdp --compiled --mxu --table-net --fused-kernel
        ...   (B5 or B10, then B6)

each with ``--platform cpu|cuda``. Every other combination of the JAX CLI
parses and then raises ``SystemExit`` with the reference's own reason, or
the port's where it refuses more (the fused kernels under ``--n-devices``
and ``--tp``). The run targets ``cuda:0`` unless ``--platform cpu`` is
given; it never falls back.

``--n-devices N`` (N > 1) trains data-parallel over N ranks, one device
each (``parallel/dp.py::DPTrainer`` around the base and MXU trainers; the
fused kernels are single-device, as in the reference). Under a launcher's
variables (``torchrun``; ``parallel/multihost.py``) this process joins the
launcher's group, whose size must be N. Otherwise the CLI starts N local
ranks itself (``parallel/launch.py``): gloo processes with ``--platform
cpu``, one NCCL process per card on cuda (``SystemExit`` if fewer cards are
visible). Every rank runs this same ``run``; a rank of data index ``d``
draws from a generator seeded ``dp.rank_seed(seed, d)``, only rank 0 logs,
and ``run`` returns the global (summed) final eval, which is the same on
every rank. ``--tp T`` lays the N ranks out as ``N/T`` data × ``T`` model
(``parallel/tp.py::TPTrainer`` around the deep agents' array-engine
trainers: the dense layers shard over ``model``, the lanes over ``data``);
the ranks of one model group share a data index, so they step the same
lanes on the same draws.

``--checkpoint-dir D`` saves ``(astate, vstate, generator)`` to ``D/<chunk>/
state.pt`` (``utils/checkpoint.py``) after every ``--checkpoint-every``-th
chunk, in the background, and at the end; under ``--n-devices N`` each
rank saves its own tree to ``D/<chunk>/rank-<r>.pt`` and rank 0 commits the
step. ``--resume`` continues from the newest readable step, bit for bit as
the uninterrupted run (a resumed DQN run skips the warmup); a checkpoint
written at another ``--n-devices`` or ``--tp`` is refused.
``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the
reference's window, the three chunks after the first.
``--debug-nans`` raises ``FloatingPointError`` at the first non-finite
stat, loss or floating agent-state value after a chunk or an eval, naming
it (the reference sets ``jax_debug_nans``); a finite run is unchanged.
"""
from __future__ import annotations

import math
import os
import sys

import torch
import torch.distributed as dist

from ..agents import make_agent
from ..device import PLATFORMS, resolve_device
from ..envs import make_env
from ..envs.array_vec import ArrayVecEnv
from ..envs.vec import VecEnv
from ..ops import dqn_update_kernel, ppo_kernel
from ..parallel import dp, launch, multihost
from ..parallel.mesh import local_rank, make_mesh
from ..parallel.tp import TPTrainer
from ..training import (
    FusedCRMDPTrainer, FusedDQNTrainer, FusedPPOTrainer, FusedTabularQTrainer,
    MXUCRMDPTrainer, MXUDQNTrainer, MXUPPOTrainer, MXUTabularQTrainer, eval_chunk,
    make_trainer, stats_to_host,
)
from ..training.dqn_fused import TB_REC, fused_update_fits
from ..training.ppo_fused import TB_P
from ..utils import checkpoint as ckpt
from ..utils.meters import MetricsLogger
from .parsing import agent_kwargs, apply_preset, prepare_parser

MXU_AGENTS = ("tabular-q", "deep-q", "ppo-mlp", "ppo-cnn", "ppo-crmdp")
TP_AGENTS = ("deep-q", "ppo-mlp", "ppo-cnn", "ppo-crmdp")
FUSED_SINGLE_DEVICE = ("--fused-kernel is single-device; drop --n-devices (the reference's "
                       "fused trainers are too; --n-devices runs the MXU and array-engine "
                       "trainers, ROADMAP A.14)")


def _refuse_unported(args) -> None:
    """Raise ``SystemExit`` for any combination this port does not run."""
    if args.agent == "tabular-q" and args.compiled and args.env in ("friend", "foe",
                                                                    "neutral"):
        # Index leak: the bounded friend family's compiled state index encodes
        # the hidden reward box and the adversary's memory, and tabular Q keys
        # its table by that index (envs/friend_foe.py). The array engine's
        # index is the position alone.
        raise SystemExit(
            "tabular-q on the compiled friend family reads the hidden reward box "
            "through its state index — run it on the array engine (drop --compiled/--mxu)")
    if args.fused_kernel and not args.mxu:
        raise SystemExit("--fused-kernel requires --compiled --mxu")
    if args.mxu and (not args.compiled or args.agent not in MXU_AGENTS):
        raise SystemExit(f"--mxu requires --compiled and one of {MXU_AGENTS}")
    if args.agent == "tabular-q" and args.fused_kernel:
        if args.cheat or args.n_devices > 1:
            raise SystemExit("--fused-kernel is single-device and trains on the "
                             "observed reward; drop --cheat/--n-devices")
        if args.env == "sokoban2":
            # The reference's fused tabular trainer asserts on its VMEM here
            # (training/tabular_pallas.py) and trains sokoban2 on its array
            # engine instead.
            raise SystemExit(
                "sokoban2 tabular-q --fused-kernel: the reference's fused tabular "
                "trainer refuses sokoban2's 175,616-slot tables; run it on the array "
                "engine (drop --compiled/--mxu/--fused-kernel)")
    elif args.agent in ("ppo-mlp", "ppo-cnn", "ppo-crmdp"):
        if args.agent == "ppo-crmdp" and args.cheat:
            raise SystemExit("ppo-crmdp trains on the observed (relabeled) rewards; "
                             "drop --cheat")
        if args.fused_kernel:
            if args.n_devices > 1:
                raise SystemExit(FUSED_SINGLE_DEVICE)
            if not args.table_net:
                raise SystemExit("--fused-kernel ppo requires --table-net (the optimize "
                                 "kernel folds the obs table into layer 1)")
            if args.n_layers not in (None, 2):
                raise SystemExit(
                    f"--n-layers {args.n_layers}: the fused PPO optimize kernel takes "
                    "two hidden layers; drop --fused-kernel for other depths")
            if args.chunk_steps % TB_P:
                raise SystemExit(
                    f"--chunk-steps {args.chunk_steps} must be a multiple of {TB_P} for "
                    "--fused-kernel ppo (the reference refuses it too)")
    elif args.agent == "deep-q":
        if args.fused_kernel:
            if args.n_devices > 1:
                raise SystemExit(FUSED_SINGLE_DEVICE)
            for flag, value in (("--chunk-steps", args.chunk_steps),
                                ("--warmup-steps", args.warmup_steps)):
                if value % TB_REC:
                    raise SystemExit(
                        f"{flag} {value} must be a multiple of {TB_REC} for "
                        "--fused-kernel deep-q (the reference refuses it too)")
    if args.n_devices < 1:
        raise SystemExit(f"--n-devices {args.n_devices}: give at least 1")
    if args.tp < 1 or args.n_devices % args.tp:
        raise SystemExit(f"--n-devices {args.n_devices} must be a multiple of --tp {args.tp}")
    if args.n_envs % (args.n_devices // args.tp):
        raise SystemExit(f"--n-envs {args.n_envs} must be a multiple of --n-devices "
                         f"{args.n_devices} / --tp {args.tp}")
    if args.tp > 1:
        # The reference's two refusals (cli/main.py:160-171), and the fused
        # kernels', which run one card.
        if args.agent not in TP_AGENTS:
            raise SystemExit(f"--tp needs a deep agent {TP_AGENTS}, got {args.agent!r}")
        if args.fused_kernel:
            raise SystemExit("--fused-kernel is single-device; drop --tp")
        if args.mxu:
            raise SystemExit("--tp with --mxu is not supported; drop one")
    if args.platform is not None and args.platform not in PLATFORMS:
        raise SystemExit(f"--platform {args.platform!r}: use one of {sorted(PLATFORMS)}")


def _refuse_unfit_shapes(args, agent) -> None:
    """On the card, raise ``SystemExit`` for a net or batch that no route of
    the fused learner kernel takes (``dqn_update_kernel.route``,
    ``ppo_kernel.route``: the resident designs for the main path's shapes,
    the grid-wide routes beyond them), before training starts. A DQN net
    that B4 does not take at all (``fused_update_fits``) runs the autograd
    update scan and is not refused. The plain versions on the CPU take any
    shape."""
    try:
        if args.agent == "deep-q" and args.fused_kernel and fused_update_fits(agent):
            H1, H2 = agent.hidden
            dqn_update_kernel.route(agent.obs_flat.shape[1], H1, H2, agent.env.n_actions,
                                    args.batch_size)
        elif args.agent in ("ppo-mlp", "ppo-crmdp") and args.fused_kernel:
            S, D = agent.obs_flat.shape
            H1, H2 = agent.hidden
            ppo_kernel.route(S, D, H1, H2, agent.env.n_actions)
    except ValueError as e:
        raise SystemExit(f"{e}: no route of the card's fused learner kernel takes this net "
                         "or batch; use a smaller --n-hidden or --batch-size, or "
                         "--platform cpu") from None


def _refuse_unfit_eval_env(args, env, eval_env) -> None:
    """Raise ``SystemExit`` before training where the ``--eval-env`` layout
    cannot be evaluated by an agent trained on ``env``: other observation
    shapes (the nets), or another state count (tabular Q). The reference
    trains and then fails at its first eval (flax's parameter-shape error)."""
    shape, eval_shape = tuple(env.obs_shape), tuple(eval_env.obs_shape)
    if shape != eval_shape or (args.agent == "tabular-q"
                               and env.num_states != eval_env.num_states):
        raise SystemExit(
            f"--eval-env {args.eval_env}: an agent trained on {args.env} "
            f"(observations {shape}, {env.num_states} states) cannot act on its "
            f"observations {eval_shape} ({eval_env.num_states} states); the reference "
            "trains and then fails at its first eval")


def _trainer(args, agent, vec):
    """The trainer the reference's CLI picks: on the compiled engine
    (``--mxu``) the fused or MXU trainers, else the array engine's."""
    if not args.mxu:
        kwargs = {} if args.agent == "ppo-crmdp" else {"cheat": args.cheat}
        if args.agent == "deep-q":
            kwargs["updates_per_chunk"] = args.updates_per_chunk
        return make_trainer(args.agent, agent, vec, **kwargs)
    if args.agent == "tabular-q":
        if args.fused_kernel:
            return FusedTabularQTrainer(agent, vec)
        return MXUTabularQTrainer(agent, vec, cheat=args.cheat)
    mode = "parity" if args.mxu_parity else "fast"
    if args.agent in ("ppo-mlp", "ppo-cnn"):
        if args.fused_kernel:
            return FusedPPOTrainer(agent, vec, cheat=args.cheat)
        return MXUPPOTrainer(agent, vec, cheat=args.cheat, mode=mode)
    if args.agent == "ppo-crmdp":
        if args.fused_kernel:
            return FusedCRMDPTrainer(agent, vec)
        return MXUCRMDPTrainer(agent, vec, mode=mode)
    cls = FusedDQNTrainer if args.fused_kernel else MXUDQNTrainer
    return cls(agent, vec, cheat=args.cheat, updates_per_chunk=args.updates_per_chunk)


def _engine(args, env, device, world: int = 1):
    """The compiled engine under ``--mxu``, else the array engine, over the
    global lanes, or a rank's share of ``world``."""
    n = args.n_envs // world
    return VecEnv(env, n) if args.mxu else ArrayVecEnv(env, n, device)


def _run_local_ranks(args, argv, platform: str) -> dict:
    """``--n-devices N`` with no group joined: N local ranks
    (``launch.spawn``), gloo processes on the CPU or one NCCL process per
    card; each runs ``run(argv)``, and rank 0's final eval is returned."""
    if platform == "cuda":
        visible = torch.cuda.device_count()
        if visible < args.n_devices:
            raise SystemExit(f"--n-devices {args.n_devices} on cuda runs one rank per card, "
                             f"and {visible} card(s) are visible; use --platform cpu for "
                             "local CPU ranks, or fewer devices")
    argv = list(argv if argv is not None else sys.argv[1:])
    return launch.spawn(run, args.n_devices, (argv,), multihost.backend_for(platform))[0]


def run(argv=None) -> dict:
    args = prepare_parser().parse_args(argv)
    if args.preset:
        args = apply_preset(args, argv if argv is not None else sys.argv[1:])
    _refuse_unported(args)
    if args.checkpoint_dir and args.resume:
        _refuse_other_layout(args)
    platform = PLATFORMS.get(args.platform, "cuda")
    joined = multihost.ensure_initialized(platform)
    if not joined and args.n_devices > 1:
        return _run_local_ranks(args, argv, platform)
    if joined and args.n_devices != dist.get_world_size():
        raise SystemExit(f"--n-devices {args.n_devices} != the {dist.get_world_size()} "
                         "ranks of the joined process group (WORLD_SIZE)")
    group = None
    if args.n_devices > 1:
        rank_dev = None  # NCCL: the local rank's card; gloo: the CPU
        if platform == "cuda" and dist.get_backend() == "gloo":
            # gloo ranks on the card (chip_smoke.py phase 10): they share the
            # visible cards.
            rank_dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
        group = make_mesh(args.n_devices // args.tp, args.tp, device=rank_dev)
    device = group.device if group is not None else resolve_device(platform)
    primary = multihost.is_primary()

    env_kw = {"device": device} if args.compiled else {}
    env = make_env(args.env, compiled=args.compiled, **env_kw)
    eval_env = None
    if args.eval_env:
        eval_env = make_env(args.eval_env, compiled=args.compiled, **env_kw)
        _refuse_unfit_eval_env(args, env, eval_env)
    vec = _engine(args, env, device)
    agent = make_agent(args.agent, env, **agent_kwargs(args))
    if device.type == "cuda":
        _refuse_unfit_shapes(args, agent)
    trainer = _trainer(args, agent, vec)
    if group is not None:
        trainer = (TPTrainer if args.tp > 1 else dp.DPTrainer)(trainer, group)

    # --eval-episodes: run each eval until ≥E episodes finish; every lane
    # finishes ≥1 episode per env.max_steps steps (timeout), so
    # ceil(E/N)+1 timeout rounds bound it.
    min_eps = args.eval_episodes
    eval_steps = args.eval_steps
    if min_eps:
        eval_steps = max(eval_steps,
                         (math.ceil(min_eps / args.n_envs) + 1) * int(env.max_steps))

    # One generator drives the run (a rank's run): training draws, resets
    # and a stochastic env's draws (deterministic envs draw nothing there).
    # A rank's seed follows its data index: the ranks of a model group step
    # the same lanes on the same draws.
    seed = args.seed if group is None else dp.rank_seed(args.seed, group.rank)
    generator = torch.Generator(device=device).manual_seed(seed)
    if args.eval_env:
        # Distributional-shift protocol: greedy eval on another layout, from
        # fresh episodes; under --n-devices each rank runs its share of the
        # lanes and of the episode target, and the stats are summed.
        eval_vec = _engine(args, eval_env, device, 1 if group is None else group.world_size)
        # The rank's agent: under --tp its net computes on the rank's shards.
        eval_agent = (agent if group is None else trainer.trainer.agent).for_env(eval_env)
        if args.mxu:
            def act(a, vs):
                return eval_agent.act_idx(a, vs.idx)
        else:
            def act(a, vs):
                return eval_agent.act(a, vs.env)

        local_eps = min_eps if group is None else dp.local_target(min_eps, group.world_size)

        def evaluate(astate):
            with torch.no_grad():
                vs, st = eval_chunk(eval_vec, act, astate, eval_vec.reset(generator),
                                    eval_steps, min_episodes=local_eps, generator=generator)
            return vs, (st if group is None else dp.psum_stats(st, group))
    else:
        reset = vec.reset if group is None else trainer.reset_envs

        def evaluate(astate):
            # Fresh episodes: the live training state would mix exploration
            # partial episodes into the eval stats.
            return trainer.eval_chunk(astate, reset(generator), eval_steps,
                                      min_episodes=min_eps, generator=generator)

    if args.agent in ("tabular-q", "random", "single"):
        astate, vstate = trainer.init(generator=generator)
    else:
        astate, vstate = trainer.init(seed=args.seed, generator=generator)

    start_chunk = 0
    layout = None
    if group is not None:
        layout = ckpt.Layout(dist.get_rank(), args.n_devices, args.tp, device)
    if args.checkpoint_dir and args.resume:
        # The generator is restored in place: the eval closures above hold it.
        step, state = ckpt.restore_latest_valid(args.checkpoint_dir,
                                                (astate, vstate, generator), layout)
        if step is not None:
            astate, vstate, _ = state
            start_chunk = step
            print(f"resumed from chunk {step}", flush=True)
    if args.agent == "deep-q" and start_chunk == 0 and args.warmup_steps > 0:
        # Random-policy replay fill (the reference's dqn warmup).
        astate, vstate, _ = trainer.warmup_chunk(astate, vstate, generator,
                                                 args.warmup_steps)

    K = args.chunks_per_dispatch
    n_chunks = max(1, args.steps // (args.chunk_steps * args.n_envs * K))
    # The reference's profiling window: three chunks past the first, clamped
    # into the run.
    profile_span, profiler = None, None
    if args.profile_dir and primary:
        p0 = min(start_chunk + 1, n_chunks - 1)
        profile_span = (p0, min(p0 + 2, n_chunks - 1))
    env_steps = start_chunk * args.chunk_steps * args.n_envs * K
    final_stats = {}
    logger = MetricsLogger(args.log_dir if primary else None, stdout=primary)
    try:
        for i in range(start_chunk, n_chunks):
            if profile_span and i == profile_span[0]:
                profiler = _start_profiler(device)
            stats, losses = None, []
            for _ in range(K):
                out = trainer.train_chunk(astate, vstate, generator, args.chunk_steps)
                astate, vstate, s = out[:3]
                losses.extend(out[3:])
                stats = s if stats is None else stats.merge(s)
            env_steps += args.chunk_steps * args.n_envs * K
            if profile_span and i == profile_span[1]:
                _stop_profiler(profiler, device, args.profile_dir, profile_span)
                profiler = profile_span = None
            if args.debug_nans:
                check_finite(f"chunk {i}", stats=stats, losses=losses, astate=astate)
            if (i + 1) % args.eval_every == 0 or i == n_chunks - 1:
                row = stats_to_host(stats)
                if losses:
                    row["loss"] = float(torch.stack(losses).mean())
                logger.log(env_steps, row, "train")
                _, es = evaluate(astate)
                if args.debug_nans:
                    check_finite(f"eval after chunk {i}", stats=es)
                final_stats = stats_to_host(es)
                logger.log(env_steps, final_stats, "eval")
            if args.checkpoint_dir and (i + 1) % args.checkpoint_every == 0:
                # After the eval: evals draw from the run's generator, so the
                # saved state is the one the next chunk starts from. The save
                # snapshots the state, then writes in the background.
                ckpt.save(args.checkpoint_dir, i + 1, (astate, vstate, generator),
                          wait=False, layout=layout)
        if args.checkpoint_dir:
            ckpt.wait_all()
            ckpt.save(args.checkpoint_dir, n_chunks, (astate, vstate, generator),
                      layout=layout)
    finally:
        if profiler is not None:
            profiler.stop()
        logger.close()
    return final_stats


def _refuse_other_layout(args) -> None:
    """``SystemExit`` where the newest committed step under
    ``--checkpoint-dir`` was written at another ``--n-devices`` or
    ``--tp``: each rank's file holds its own lanes, ring and shards."""
    steps = ckpt.committed_steps(os.path.abspath(args.checkpoint_dir))
    if not steps:
        return
    saved = ckpt.step_layout(os.path.abspath(args.checkpoint_dir), steps[-1])
    if saved != {"world": args.n_devices, "tp": args.tp}:
        raise SystemExit(
            f"--resume: step {steps[-1]} under {args.checkpoint_dir} was written at "
            f"--n-devices {saved['world']} --tp {saved['tp']}, this run is --n-devices "
            f"{args.n_devices} --tp {args.tp}; resume at the writer's layout")


def check_finite(where: str, **trees) -> None:
    """``--debug-nans``: raise ``FloatingPointError`` naming the first
    floating leaf of ``trees`` (paths as ``checkpoint.leaves`` gives them)
    that holds a NaN or an infinity. One host read when all are finite."""
    floats = [("/".join((name,) + path), x) for name, tree in trees.items()
              for path, x in ckpt.leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not floats:
        return
    ok = torch.stack([torch.isfinite(x).all() for _, x in floats])
    if bool(ok.all()):
        return
    bad = int((~ok.cpu()).nonzero()[0])
    raise FloatingPointError(f"--debug-nans: {where}: non-finite value in {floats[bad][0]}")


def _start_profiler(device):
    """``torch.profiler`` over CPU activity, and the card's where it runs."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device, profile_dir: str, span) -> str:
    """Stop ``prof`` once the card is idle and write its Chrome trace under
    ``profile_dir``; returns the trace's path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"chunks_{span[0]}-{span[1]}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None):
    stats = run(argv)
    if not multihost.is_primary():
        return
    print("final eval:", {k: round(v, 3) for k, v in stats.items()}, flush=True)


if __name__ == "__main__":
    main()
