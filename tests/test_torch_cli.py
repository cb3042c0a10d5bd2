"""The port's CLI: the main path end to end on the CPU, and refusals.

``run`` drives ``shift tabular-q --compiled --mxu --fused-kernel`` through
the fused trainer (its plain kernel version on the CPU) and must reach the
shift optimum; every combination the port does not run yet must raise
``SystemExit`` naming what is missing.
"""
import json

import pytest
import torch

from safe_grid_agents_torch.agents import make_agent
from safe_grid_agents_torch.cli.main import _refuse_unfit_shapes, run
from safe_grid_agents_torch.cli.parsing import agent_kwargs, apply_preset, prepare_parser
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.ops import dqn_update_kernel as duk
from safe_grid_agents_torch.ops import ppo_kernel as pk
from safe_grid_agents_torch.ops import tabular_kernel as tk
from safe_grid_agents_torch.tools import learner_cases as lc

torch.set_num_threads(1)
MAIN = ["shift", "tabular-q", "--compiled", "--mxu", "--fused-kernel"]
CPU = ["--platform", "cpu"]


def test_cli_preset_reaches_shift_optimum():
    tk.counts.reset()
    stats = run(MAIN + ["--preset"] + CPU)
    assert stats["mean_return"] > 38.0, stats  # shift optimum is 40
    # 80000 // (128 · 64) = 9 chunks, each one call of the fused kernel's
    # plain version on the CPU.
    assert tk.counts.plain_calls == 9 and tk.counts.launches == 0


def test_cli_eval_on_shifted_layout_logs_jsonl(tmp_path):
    """Train on shift, evaluate greedily on shift-test: the memorised path
    runs through the moved lava band."""
    stats = run(MAIN + ["--preset", "--eval-env", "shift-test",
                        "--chunks-per-dispatch", "3", "--eval-every", "2",
                        "--eval-episodes", "80", "--log-dir", str(tmp_path)] + CPU)
    assert stats["episodes"] >= 80
    assert stats["mean_return"] < 0.0, stats
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["prefix"] for r in recs][-2:] == ["train", "eval"]
    assert recs[-1]["step"] == 3 * 3 * 128 * 64


@pytest.mark.parametrize("argv, match", [
    (["shift", "deep-q", "--compiled", "--mxu"], "A.9"),
    (["shift", "ppo-cnn", "--compiled", "--mxu"], "A.10"),
    (["boat", "tabular-q", "--compiled", "--mxu", "--fused-kernel"], "A.8"),
    (["absent", "deep-q", "--compiled", "--mxu", "--fused-kernel", "--prioritized"], "A.9"),
    (["shift", "tabular-q"], "A.6"),
    (["shift", "tabular-q", "--compiled", "--mxu"], "A.6"),
    (["shift", "tabular-q", "--compiled", "--fused-kernel"], "requires --compiled --mxu"),
    (MAIN + ["--checkpoint-dir", "ckpt"], "A.7"),
    (MAIN + ["--resume"], "A.7"),
    (MAIN + ["--profile-dir", "prof"], "A.7"),
    (MAIN + ["--n-devices", "2"], "single-device"),
    (MAIN + ["--cheat"], "single-device"),
    (MAIN + ["--tp", "2"], "A.14"),
    (MAIN + ["--table-net"], "table-net"),
    (MAIN + ["--platform", "tpu"], "platform"),
])
def test_cli_refuses_unported(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + (CPU if "--platform" not in argv else []))


@pytest.mark.parametrize("alias", ["friend", "foe", "neutral"])
def test_cli_friend_family_tabular_refusal_names_what_is_missing(alias):
    """The refusal names the unported array engine (ROADMAP A.6) and does
    not send the user to a command the port refuses as well."""
    with pytest.raises(SystemExit) as exc:
        run([alias, "tabular-q", "--compiled", "--mxu", "--fused-kernel"] + CPU)
    message = str(exc.value)
    assert "A.6" in message and "hidden reward box" in message, message
    assert "drop --compiled" not in message, message


SOKOBAN_DQN = ["sokoban", "deep-q", "--compiled", "--mxu", "--fused-kernel", "--n-envs", "128",
               "--chunk-steps", "32", "--batch-size", "128", "--warmup-steps", "32",
               "--updates-per-chunk", "32", "--n-step", "3"]
ISLAND_PPO = ["island", "ppo-mlp", "--preset", "--compiled", "--mxu", "--table-net",
              "--fused-kernel"]


def _card_shape_check(argv):
    """The CLI's shape check for a card run, on an agent built on the CPU."""
    args = prepare_parser().parse_args(argv)
    if args.preset:
        args = apply_preset(args, argv)
    agent = make_agent(args.agent, make_env(args.env, compiled=True, device="cpu"),
                       **agent_kwargs(args))
    _refuse_unfit_shapes(args, agent)


def _card_route(argv):
    """The route the card's learner kernel takes for ``argv``'s net and batch."""
    args = prepare_parser().parse_args(argv)
    if args.preset:
        args = apply_preset(args, argv)
    agent = make_agent(args.agent, make_env(args.env, compiled=True, device="cpu"),
                       **agent_kwargs(args))
    S, D = agent.obs_flat.shape
    H1, H2 = agent.hidden
    if args.agent == "deep-q":
        return duk.route(D, H1, H2, agent.env.n_actions, args.batch_size)
    return pk.route(S, D, H1, H2, agent.env.n_actions)


@pytest.mark.parametrize("argv, kernel", [
    (SOKOBAN_DQN + ["--n-hidden", "512"], "B4"),
    (SOKOBAN_DQN + ["--batch-size", "4096"], "B4"),
    (ISLAND_PPO + ["--n-hidden", "256"], "B6"),
])
def test_cli_refuses_shapes_the_card_kernels_cannot_hold(argv, kernel):
    """The shapes that B4's cluster and B6's persistent design cannot hold
    in shared memory (refused on the card until the wide routes came back)
    are now taken: the CLI's card check passes, and the route chooser picks
    B4's grid route or B6's wide route."""
    _card_shape_check(argv)
    assert _card_route(argv) == {"B4": "grid", "B6": "wide"}[kernel]


@pytest.mark.parametrize("argv", [SOKOBAN_DQN, lc.DQN_WHISKY, ISLAND_PPO, lc.PPO_ABSENT])
def test_cli_takes_the_main_path_shapes_on_the_card(argv):
    _card_shape_check(argv)
    assert _card_route(argv) in ("cluster", "persistent")
