"""Experiment entry point — counterpart of ``safe_grid_agents_tpu/cli/main.py``.

parse → build env/agent/trainer → warmup → chunked train loop with periodic
greedy eval and metrics → final eval. The port runs these paths end to end:

    <shift|shift-test> tabular-q --compiled --mxu --fused-kernel
        [--preset] [--eval-env shift|shift-test]
    <absent|interrupt|whisky|tomato|tomato-crmdp> tabular-q --compiled --mxu
        --fused-kernel ...            (the stochastic kernel B8)
    <alias> deep-q --compiled --mxu --fused-kernel [--table-net]
        [--double-q] [--n-step n] [--cheat] ...   (sokoban: BASELINE config
        3; the stochastic aliases collect on B9)
    <alias> ppo-mlp --compiled --mxu [--table-net [--fused-kernel]]
        [--preset] [--cheat] ...     (island's preset is BASELINE config 4;
        the stochastic aliases collect on B10 under --fused-kernel)

each with ``--platform cpu|cuda``. Every other combination of the JAX CLI
parses and then raises ``SystemExit`` naming the ROADMAP item that ports
it. The run targets ``cuda:0`` unless ``--platform cpu`` is given; it never
falls back.
"""
from __future__ import annotations

import math
import sys

import torch

from ..agents import UNPORTED_AGENTS, make_agent
from ..device import resolve_device
from ..envs import UNPORTED_ENVS, make_env
from ..envs.vec import VecEnv
from ..ops import dqn_update_kernel, ppo_kernel
from ..training import (
    FusedDQNTrainer, FusedPPOTrainer, FusedTabularQTrainer, MXUPPOTrainer,
    eval_chunk, stats_to_host,
)
from ..training.dqn_fused import TB_REC
from ..training.ppo_fused import TB_P
from ..utils.meters import MetricsLogger
from .parsing import agent_kwargs, apply_preset, prepare_parser

PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}
PER_FLAGS = ("prioritized", "per_alpha", "per_beta", "per_clip", "per_eps")


def _refuse_unported(args) -> None:
    """Raise ``SystemExit`` for any combination this port does not run."""
    if args.agent in UNPORTED_AGENTS:
        raise SystemExit(f"agent {args.agent!r} is not ported yet "
                         f"(ROADMAP {UNPORTED_AGENTS[args.agent]})")
    for alias in (args.env, args.eval_env):
        if alias in UNPORTED_ENVS:
            raise SystemExit(f"env {alias!r} is not ported yet "
                             f"(ROADMAP {UNPORTED_ENVS[alias]})")
    if args.agent == "tabular-q" and args.compiled and args.env in ("friend", "foe",
                                                                    "neutral"):
        # Index leak: the bounded friend family's compiled state index encodes
        # the hidden reward box and the adversary's memory, and tabular Q keys
        # its table by that index (envs/friend_foe.py).
        raise SystemExit(
            "tabular-q on the compiled friend family reads the hidden reward box "
            "through its state index; the reference runs it on its array engine, "
            "which the port does not have yet (the array-engine VecEnv and the base "
            "tabular trainer, ROADMAP A.4 + A.6)")
    if args.fused_kernel and not args.mxu:
        raise SystemExit("--fused-kernel requires --compiled --mxu")
    if args.mxu and not args.compiled:
        raise SystemExit("--mxu requires --compiled")
    if args.agent == "tabular-q":
        if not (args.compiled and args.mxu and args.fused_kernel):
            raise SystemExit(
                "tabular-q runs only as --compiled --mxu --fused-kernel so far; "
                "training/tabular.py and the MXU tabular scan are not ported yet "
                "(ROADMAP A.6)"
            )
        if args.cheat or args.n_devices > 1:
            raise SystemExit("--fused-kernel is single-device and trains on the "
                             "observed reward; drop --cheat/--n-devices")
    elif args.agent == "ppo-mlp":
        if args.mxu_parity:
            raise SystemExit("--mxu-parity (the base PPO optimize with an element "
                             "permutation) is not ported yet (ROADMAP A.10)")
        if not (args.compiled and args.mxu):
            raise SystemExit(
                "ppo-mlp runs only as --compiled --mxu so far; the base PPOTrainer "
                "over the array engine is not ported yet (ROADMAP A.10)")
        if args.n_devices > 1:
            raise SystemExit("ppo-mlp is single-device so far; drop --n-devices "
                             "(multi-device: ROADMAP A.14)")
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
    else:  # deep-q
        if not (args.compiled and args.mxu and args.fused_kernel):
            raise SystemExit(
                "deep-q runs only as --compiled --mxu --fused-kernel so far; the "
                "MXU update scan (MXUDQNTrainer) and the VecEnv trainer "
                "(DQNTrainer) are not ported yet (ROADMAP A.9)"
            )
        if any(getattr(args, f) for f in PER_FLAGS):
            raise SystemExit(
                "prioritized replay (--prioritized, --per-*) is not ported yet; the "
                "reference pins it to its XLA update scan (ROADMAP A.9)")
        if args.n_layers not in (None, 2):
            raise SystemExit(
                f"--n-layers {args.n_layers}: the fused update kernel takes two "
                "hidden layers; the reference runs other depths on its XLA update "
                "scan, which is not ported yet (ROADMAP A.9)")
        if args.n_devices > 1:
            raise SystemExit("--fused-kernel is single-device; drop --n-devices "
                             "(multi-device: ROADMAP A.14)")
        for flag, value in (("--chunk-steps", args.chunk_steps),
                            ("--warmup-steps", args.warmup_steps)):
            if value % TB_REC:
                raise SystemExit(
                    f"{flag} {value} must be a multiple of {TB_REC} for "
                    "--fused-kernel deep-q (the reference refuses it too)")
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
    the grid-wide routes beyond them), before training starts. The plain
    versions on the CPU take any shape."""
    try:
        if args.agent == "deep-q":
            H1, H2 = agent.hidden
            dqn_update_kernel.route(agent.obs_flat.shape[1], H1, H2, agent.env.n_actions,
                                    args.batch_size)
        elif args.agent == "ppo-mlp" and args.fused_kernel:
            S, D = agent.obs_flat.shape
            H1, H2 = agent.hidden
            ppo_kernel.route(S, D, H1, H2, agent.env.n_actions)
    except ValueError as e:
        raise SystemExit(f"{e}: no route of the card's fused learner kernel takes this net "
                         "or batch; use a smaller --n-hidden or --batch-size, or "
                         "--platform cpu") from None


def _trainer(args, agent, vec):
    if args.agent == "tabular-q":
        return FusedTabularQTrainer(agent, vec)
    if args.agent == "ppo-mlp":
        cls = FusedPPOTrainer if args.fused_kernel else MXUPPOTrainer
        return cls(agent, vec, cheat=args.cheat)
    return FusedDQNTrainer(agent, vec, cheat=args.cheat,
                           updates_per_chunk=args.updates_per_chunk)


def run(argv=None) -> dict:
    args = prepare_parser().parse_args(argv)
    if args.preset:
        args = apply_preset(args, argv if argv is not None else sys.argv[1:])
    _refuse_unported(args)
    device = resolve_device(PLATFORMS.get(args.platform, "cuda"))

    env = make_env(args.env, compiled=True, device=device)
    vec = VecEnv(env, args.n_envs)
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

    # One generator drives the run: training draws, stochastic resets and a
    # stochastic env's eval draws (deterministic envs draw nothing there).
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.eval_env:
        # Distributional-shift protocol: greedy eval on another layout, from
        # fresh episodes.
        eval_vec = VecEnv(make_env(args.eval_env, compiled=True, device=device),
                          args.n_envs)
        eval_agent = agent.for_env(eval_vec.cenv)

        def evaluate(astate):
            return eval_chunk(eval_vec, lambda a, vs: eval_agent.act_idx(a, vs.idx),
                              astate, eval_vec.reset(generator), eval_steps,
                              min_episodes=min_eps, generator=generator)
    else:
        stoch = {"generator": generator} if vec.stochastic else {}

        def evaluate(astate):
            # Fresh episodes: the live training state would mix exploration
            # partial episodes into the eval stats.
            return trainer.eval_chunk(astate, vec.reset(generator), eval_steps,
                                      min_episodes=min_eps, **stoch)

    if args.agent == "tabular-q":
        astate, vstate = trainer.init(generator)
    else:
        astate, vstate = trainer.init(seed=args.seed, generator=generator)
    if args.agent == "deep-q":
        if args.warmup_steps > 0:
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
