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
parses and then raises ``SystemExit``: with the reference's own reason
where the reference refuses it, else naming the ROADMAP item that ports it
(checkpointing and profiling, A.7; multi-device, A.14).
The run targets ``cuda:0`` unless ``--platform cpu`` is given; it never
falls back.
"""
from __future__ import annotations

import math
import sys

import torch

from ..agents import make_agent
from ..device import resolve_device
from ..envs import make_env
from ..envs.array_vec import ArrayVecEnv
from ..envs.vec import VecEnv
from ..ops import dqn_update_kernel, ppo_kernel
from ..training import (
    FusedCRMDPTrainer, FusedDQNTrainer, FusedPPOTrainer, FusedTabularQTrainer,
    MXUCRMDPTrainer, MXUDQNTrainer, MXUPPOTrainer, MXUTabularQTrainer, eval_chunk,
    make_trainer, stats_to_host,
)
from ..training.dqn_fused import TB_REC, fused_update_fits
from ..training.ppo_fused import TB_P
from ..utils.meters import MetricsLogger
from .parsing import agent_kwargs, apply_preset, prepare_parser

PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}
MXU_AGENTS = ("tabular-q", "deep-q", "ppo-mlp", "ppo-cnn", "ppo-crmdp")


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
        if args.n_devices > 1:
            raise SystemExit(f"{args.agent} is single-device so far; drop --n-devices "
                             "(multi-device: ROADMAP A.14)")
        if args.agent == "ppo-crmdp" and args.cheat:
            raise SystemExit("ppo-crmdp trains on the observed (relabeled) rewards; "
                             "drop --cheat")
        if args.fused_kernel:
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
                raise SystemExit("--fused-kernel is single-device; drop --n-devices "
                                 "(multi-device: ROADMAP A.14)")
            for flag, value in (("--chunk-steps", args.chunk_steps),
                                ("--warmup-steps", args.warmup_steps)):
                if value % TB_REC:
                    raise SystemExit(
                        f"{flag} {value} must be a multiple of {TB_REC} for "
                        "--fused-kernel deep-q (the reference refuses it too)")
    if args.n_devices > 1:
        raise SystemExit("--n-devices > 1 is not ported yet (multi-device: ROADMAP A.14)")
    if args.tp > 1:
        raise SystemExit("--tp is not ported yet (ROADMAP A.14)")
    if args.checkpoint_dir or args.resume:
        raise SystemExit("checkpointing (--checkpoint-dir/--resume) is not "
                         "ported yet (ROADMAP A.7)")
    if args.profile_dir or args.debug_nans:
        raise SystemExit("--profile-dir/--debug-nans are not ported yet "
                         "(ROADMAP A.7)")
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


def _engine(args, env, device):
    """The compiled engine under ``--mxu``, else the array engine."""
    return VecEnv(env, args.n_envs) if args.mxu else ArrayVecEnv(env, args.n_envs, device)


def run(argv=None) -> dict:
    args = prepare_parser().parse_args(argv)
    if args.preset:
        args = apply_preset(args, argv if argv is not None else sys.argv[1:])
    _refuse_unported(args)
    device = resolve_device(PLATFORMS.get(args.platform, "cuda"))

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

    # --eval-episodes: run each eval until ≥E episodes finish; every lane
    # finishes ≥1 episode per env.max_steps steps (timeout), so
    # ceil(E/N)+1 timeout rounds bound it.
    min_eps = args.eval_episodes
    eval_steps = args.eval_steps
    if min_eps:
        eval_steps = max(eval_steps,
                         (math.ceil(min_eps / args.n_envs) + 1) * int(env.max_steps))

    # One generator drives the run: training draws, resets and a stochastic
    # env's draws (deterministic envs draw nothing there).
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.eval_env:
        # Distributional-shift protocol: greedy eval on another layout, from
        # fresh episodes.
        eval_vec = _engine(args, eval_env, device)
        eval_agent = agent.for_env(eval_env)
        if args.mxu:
            def act(a, vs):
                return eval_agent.act_idx(a, vs.idx)
        else:
            def act(a, vs):
                return eval_agent.act(a, vs.env)

        def evaluate(astate):
            with torch.no_grad():
                return eval_chunk(eval_vec, act, astate, eval_vec.reset(generator),
                                  eval_steps, min_episodes=min_eps, generator=generator)
    else:
        def evaluate(astate):
            # Fresh episodes: the live training state would mix exploration
            # partial episodes into the eval stats.
            return trainer.eval_chunk(astate, vec.reset(generator), eval_steps,
                                      min_episodes=min_eps, generator=generator)

    if args.agent in ("tabular-q", "random", "single"):
        astate, vstate = trainer.init(generator=generator)
    else:
        astate, vstate = trainer.init(seed=args.seed, generator=generator)
    if args.agent == "deep-q" and args.warmup_steps > 0:
        # Random-policy replay fill (the reference's dqn warmup).
        astate, vstate, _ = trainer.warmup_chunk(astate, vstate, generator,
                                                 args.warmup_steps)

    K = args.chunks_per_dispatch
    n_chunks = max(1, args.steps // (args.chunk_steps * args.n_envs * K))
    env_steps = 0
    final_stats = {}
    logger = MetricsLogger(args.log_dir)
    try:
        for i in range(n_chunks):
            stats, losses = None, []
            for _ in range(K):
                out = trainer.train_chunk(astate, vstate, generator, args.chunk_steps)
                astate, vstate, s = out[:3]
                losses.extend(out[3:])
                stats = s if stats is None else stats.merge(s)
            env_steps += args.chunk_steps * args.n_envs * K
            if (i + 1) % args.eval_every == 0 or i == n_chunks - 1:
                row = stats_to_host(stats)
                if losses:
                    row["loss"] = float(torch.stack(losses).mean())
                logger.log(env_steps, row, "train")
                _, es = evaluate(astate)
                final_stats = stats_to_host(es)
                logger.log(env_steps, final_stats, "eval")
    finally:
        logger.close()
    return final_stats


def main(argv=None):
    stats = run(argv)
    print("final eval:", {k: round(v, 3) for k, v in stats.items()}, flush=True)


if __name__ == "__main__":
    main()
