"""CLI argument surface — counterpart of ``safe_grid_agents_tpu/cli/parsing.py``.

Positional env alias → positional agent alias → per-agent flags, with the
JAX CLI's flag names and flag groups. Every alias of the JAX CLI parses;
``cli/main.py`` refuses the combinations this port does not run yet.
``--preset`` reads the port's own ``cli/presets.json`` (the shift, sokoban,
absent, island, boat, corners, tomato-crmdp and way entries of the JAX
package's presets, ppo-cnn's included).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

from ..agents import ALL_AGENT_ALIASES
from ..envs import ALL_ENV_ALIASES

# flag → (type, help); default None means "use the agent's default".
AGENT_FLAGS: Dict[str, Dict[str, tuple]] = {
    "common": {
        "--lr": (float, "learning rate"),
        "--discount": (float, "discount factor γ"),
    },
    "explorer": {
        "--epsilon": (float, "initial exploration rate"),
        "--epsilon-final": (float, "final exploration rate"),
        "--epsilon-anneal-steps": (int, "linear anneal horizon (env steps)"),
    },
    "net": {
        "--n-layers": (int, "hidden layers in the policy/Q net"),
        "--n-hidden": (int, "units per hidden layer"),
        "--table-net": (bool, "fold the compiled env's observation table "
                              "into the first dense layer (deep-q and ppo-mlp)"),
    },
    "deep-q": {
        "--batch-size": (int, "replay sample size per update"),
        "--replay-capacity": (int, "replay ring capacity (global)"),
        "--sync-every": (int, "target-network hard sync period (updates)"),
        "--double-q": (bool, "double DQN"),
        "--prioritized": (bool, "prioritized replay"),
        "--per-alpha": (float, "PER priority exponent α"),
        "--per-beta": (float, "PER initial importance-correction β"),
        "--per-clip": (float, "PER priority clip on |TD error|"),
        "--per-eps": (float, "PER resample floor as a fraction of the clip"),
        "--n-step": (int, "n-step return horizon for the TD target"),
    },
    "ppo": {
        "--clipping": (float, "PPO clip ε"),
        "--entropy-bonus": (float, "entropy bonus coefficient"),
        "--entropy-final": (float, "annealed final entropy coefficient"),
        "--entropy-anneal-steps": (int, "entropy anneal horizon (env steps; 0=const)"),
        "--epochs": (int, "optimization epochs per rollout"),
        "--n-minibatches": (int, "minibatches per epoch"),
        "--gae-lambda": (float, "GAE λ"),
        "--value-coef": (float, "value-loss coefficient"),
    },
    "ppo-crmdp": {
        "--crmdp-lr": (float, "corruption-attribution NLMS step size"),
    },
}

# Which flag groups feed which agent's constructor.
AGENT_GROUPS = {
    "random": [],
    "single": [],
    "tabular-q": ["common", "explorer"],
    "deep-q": ["common", "explorer", "net", "deep-q"],
    "ppo-mlp": ["common", "net", "ppo"],
    "ppo-cnn": ["common", "net", "ppo"],
    "ppo-crmdp": ["common", "net", "ppo", "ppo-crmdp"],
}

PRESETS_PATH = os.path.join(os.path.dirname(__file__), "presets.json")


def prepare_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="safe_grid_agents_torch",
        description="Safety-gridworlds RL on PyTorch/CUDA (usage mirrors the "
        "reference: <env-alias> <agent-alias> [flags])",
    )
    p.add_argument("env", choices=ALL_ENV_ALIASES, help="environment alias")
    p.add_argument("agent", choices=ALL_AGENT_ALIASES, help="agent alias")

    run = p.add_argument_group("run")
    run.add_argument("--preset", action="store_true",
                     help="apply the known-good preset for this (env, agent) "
                          "from cli/presets.json; explicit flags override")
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--log-dir", type=str, default=None)
    run.add_argument("--n-envs", type=int, default=128, help="vectorized env instances")
    run.add_argument("--steps", type=int, default=500_000, help="total env steps")
    run.add_argument("--chunk-steps", type=int, default=64, help="env steps per fused chunk")
    run.add_argument("--chunks-per-dispatch", type=int, default=1,
                     help="train chunks run back to back per logging step "
                          "(stats are merged over them; logging and eval "
                          "cadence count these groups)")
    run.add_argument("--eval-every", "--eval-period", dest="eval_every",
                     type=int, default=20,
                     help="eval every N chunks (reference: --eval-period)")
    run.add_argument("--eval-steps", type=int, default=120, help="greedy eval steps")
    run.add_argument("--eval-episodes", type=int, default=None,
                     help="run each eval until at least this many episodes "
                          "finish; the step bound grows as needed via the "
                          "episode timeout")
    run.add_argument("--cheat", action="store_true",
                     help="train on the hidden performance signal (debug upper bound)")
    run.add_argument("--compiled", action="store_true",
                     help="lower the env to the lookup-table engine")
    run.add_argument("--mxu", action="store_true",
                     help="step the env on the table-gather VecEnv (the JAX "
                          "CLI's MXU engine; requires --compiled)")
    run.add_argument("--fused-kernel", action="store_true",
                     help="with --mxu: tabular-q runs the whole act→step→learn "
                          "loop inside one CUDA kernel (ops/tabular_kernel.py, "
                          "ops/tabular_stoch_kernel.py on the stochastic aliases); "
                          "deep-q runs its collect and its update phase in one "
                          "kernel each (ops/dqn_kernel.py or, on the stochastic "
                          "aliases, ops/dqn_stoch_kernel.py; ops/dqn_update_kernel.py); "
                          "ppo-mlp (with --table-net) likewise "
                          "(ops/ppo_collect_kernel.py or ops/ppo_stoch_collect_kernel.py; "
                          "ops/ppo_kernel.py)")
    run.add_argument("--mxu-parity", action="store_true",
                     help="ppo agents on --mxu: the base trainer's optimize with "
                          "element permutations (a chunk bitwise the base "
                          "trainer's) instead of the tile-shuffled fast mode")
    run.add_argument("--n-devices", type=int, default=1,
                     help="data-parallel ranks, one per device: N local gloo processes "
                          "with --platform cpu, one NCCL process per card on cuda, or the "
                          "launcher's WORLD_SIZE under torchrun")
    run.add_argument("--tp", type=int, default=1,
                     help="tensor-parallel width (only 1 is ported)")
    run.add_argument("--warmup-steps", type=int, default=64,
                     help="random-policy replay warmup (deep-q only)")
    run.add_argument("--updates-per-chunk", type=int, default=None,
                     help="gradient updates per chunk (deep-q only)")

    run.add_argument("--eval-env", type=str, default=None, choices=ALL_ENV_ALIASES,
                     help="evaluate on a different env alias (the "
                          "distributional-shift protocol: train on 'shift', "
                          "eval on 'shift-test')")
    run.add_argument("--platform", type=str, default=None,
                     help="'cuda' (default; raises without a card) or 'cpu'")
    run.add_argument("--debug-nans", action="store_true",
                     help="raise FloatingPointError at the first non-finite stat, "
                          "loss or agent-state value (checked after every chunk and eval)")
    run.add_argument("--profile-dir", type=str, default=None,
                     help="write a torch.profiler Chrome trace of the three chunks after "
                          "the first (CUDA activity included on the card)")

    ckpt = p.add_argument_group("checkpoint")
    ckpt.add_argument("--checkpoint-dir", type=str, default=None)
    ckpt.add_argument("--checkpoint-every", type=int, default=50, help="chunks")
    ckpt.add_argument("--resume", action="store_true")

    agent = p.add_argument_group("agent")
    seen = set()
    for group in AGENT_FLAGS.values():
        for flag, (typ, help_) in group.items():
            if flag in seen:
                continue
            if typ is bool:
                # default=None (not False) so agent_kwargs only forwards the
                # flag when the user passed it; --no-<flag> overrides a preset.
                agent.add_argument(flag, action="store_true", default=None, help=help_)
                agent.add_argument(
                    f"--no-{flag[2:]}", dest=flag[2:].replace("-", "_"),
                    action="store_false", default=None,
                    help=f"disable {flag} (e.g. over a preset)",
                )
            else:
                agent.add_argument(flag, type=typ, default=None, help=help_)
            seen.add(flag)
    return p


def apply_preset(args: argparse.Namespace, argv) -> argparse.Namespace:
    """Overlay preset values for (env, agent) under flags the user did NOT
    pass explicitly."""
    with open(PRESETS_PATH) as f:
        presets = json.load(f)
    table = (presets.get(args.env) or {}).get(args.agent)
    if not table:
        raise SystemExit(
            f"no preset for env {args.env!r} + agent {args.agent!r}; "
            f"available: { {e: sorted(a) for e, a in presets.items()} }"
        )
    # Explicit flags may appear as '--flag value', '--flag=value', or an
    # unambiguous argparse prefix abbreviation: an exact flag marks exactly
    # itself (`--epsilon` does NOT shadow the preset's `--epsilon-final`), a
    # prefix marks a flag only when the match is unique.
    known = {
        s for s in prepare_parser()._option_string_actions if s.startswith("--")
    }
    explicit = set()
    for tok in argv or []:
        if not tok.startswith("--"):
            continue
        tok = tok.split("=", 1)[0]
        if tok in known:
            explicit.add(tok)
        else:
            matches = [f for f in known if f.startswith(tok)]
            if len(matches) == 1:
                explicit.add(matches[0])

    for flag, value in table.items():
        if f"--{flag}" in explicit or f"--no-{flag}" in explicit:
            continue
        setattr(args, flag.replace("-", "_"), value)
    return args


def agent_kwargs(args: argparse.Namespace) -> Dict[str, Any]:
    """Constructor kwargs for the chosen agent: only flags the user set,
    filtered to the agent's flag groups."""
    out: Dict[str, Any] = {}
    for group in AGENT_GROUPS[args.agent]:
        for flag in AGENT_FLAGS[group]:
            name = flag.lstrip("-").replace("-", "_")
            val = getattr(args, name)
            if val is not None:
                out[name] = val
    # Net-shape flags translate to the agents' ``hidden`` tuple; either flag
    # alone keeps the other dimension at its default (2 × 128).
    n_layers = out.pop("n_layers", None)
    n_hidden = out.pop("n_hidden", None)
    if n_layers is not None or n_hidden is not None:
        out["hidden"] = (n_hidden or 128,) * (n_layers or 2)
    out.pop("table_net", None)
    if getattr(args, "table_net", None):
        if not args.compiled:
            raise SystemExit("--table-net requires --compiled")
        if args.agent == "deep-q":
            out["table"] = True
        elif args.agent in ("ppo-mlp", "ppo-crmdp"):
            out["net"] = "table"
        else:
            raise SystemExit("--table-net supports deep-q, ppo-mlp, and ppo-crmdp, "
                             f"not {args.agent!r}")
    return out
