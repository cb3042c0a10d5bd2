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


def test_cli_boat_tabular_runs_on_the_fused_trainer():
    """boat is ported: its fused tabular command runs B2's plain version on
    every chunk (the reference's MXU goldens' recipe, cut to 4 chunks)."""
    from safe_grid_agents_torch.ops import tabular_kernel as tk

    tk.counts.reset()
    stats = run(["boat", "tabular-q", "--compiled", "--mxu", "--fused-kernel", "--n-envs",
                 "64", "--chunk-steps", "128", "--steps", str(4 * 128 * 64), "--lr", "0.2",
                 "--epsilon-anneal-steps", "20000", "--eval-steps", "100"] + CPU)
    assert tk.counts.plain_calls == 4 and tk.counts.launches == 0
    assert stats["episodes"] == 64 and stats["mean_length"] == 100.0


@pytest.mark.parametrize("argv, match", [
    (["shift", "ppo-cnn", "--compiled", "--mxu", "--fused-kernel"], "requires --table-net"),
    (["boat", "random", "--compiled", "--mxu"], "--mxu requires --compiled and one of"),
    (["shift", "tabular-q", "--compiled", "--fused-kernel"], "requires --compiled --mxu"),
    (MAIN + ["--n-devices", "2"], "single-device"),
    (MAIN + ["--cheat"], "single-device"),
    (MAIN + ["--tp", "2"], "A.14"),
    (MAIN + ["--table-net"], "table-net"),
    (MAIN + ["--platform", "tpu"], "platform"),
])
def test_cli_refuses_unported(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + (CPU if "--platform" not in argv else []))


@pytest.mark.parametrize("argv", [
    ["shift", "deep-q", "--compiled", "--mxu"],
    ["shift", "ppo-cnn", "--compiled", "--mxu"],
    ["absent", "deep-q", "--compiled", "--mxu", "--fused-kernel", "--prioritized"],
])
def test_cli_runs_what_was_refused(argv, tmp_path):
    """Once refused (ROADMAP A.9, A.10): ``MXUDQNTrainer``, ``ppo-cnn`` on
    the MXU PPO trainer, and PER on the fused trainer over absent (B9's
    plain version, then the autograd scan); each logs a finite loss."""
    run(argv + ["--n-envs", "32", "--steps", "2048", "--chunk-steps", "32",
                "--warmup-steps", "32", "--eval-every", "1", "--eval-steps", "20",
                "--log-dir", str(tmp_path)] + CPU)
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train = [r for r in rows if r["prefix"] == "train"]
    assert len(train) == 2 and all(r["loss"] is not None and abs(r["loss"]) < 1e6
                                   for r in train)


@pytest.mark.parametrize("argv", [["shift", "tabular-q"],
                                  ["shift", "tabular-q", "--compiled", "--mxu"]])
def test_cli_runs_the_array_engine_and_the_mxu_tabular_scan(argv):
    """Once refused (ROADMAP A.6): the array engine's tabular trainer and the
    MXU tabular scan over the compiled engine run the shift command."""
    stats = run(argv + ["--n-envs", "16", "--steps", "4096", "--chunk-steps", "64",
                        "--eval-steps", "30"] + CPU)
    assert stats["env_steps"] == 30 * 16 and stats["episodes"] > 0


@pytest.mark.parametrize("alias", ["friend", "foe", "neutral"])
def test_cli_friend_family_tabular_refusal_names_what_is_missing(alias):
    """The refusal names the leak (the compiled index holds the hidden reward
    box) and sends the user to the array engine, which runs the command."""
    with pytest.raises(SystemExit) as exc:
        run([alias, "tabular-q", "--compiled", "--mxu", "--fused-kernel"] + CPU)
    message = str(exc.value)
    assert "hidden reward box" in message and "drop --compiled" in message, message
    assert "array engine" in message, message


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


# The reference's preset tests (tests/test_cli.py), against the port's parser.
def test_preset_not_shadowed_by_flag_prefix():
    """--epsilon must mark ONLY --epsilon as explicit: the island deep-q
    preset's epsilon-final / epsilon-anneal-steps still apply."""
    argv = ["island", "deep-q", "--preset", "--epsilon", "0.5"]
    args = apply_preset(prepare_parser().parse_args(argv), argv)
    assert args.epsilon == 0.5                      # user's explicit value
    assert args.epsilon_final == 0.1                # from the preset
    assert args.epsilon_anneal_steps == 2400000     # from the preset


def test_no_flag_overrides_preset_bool():
    """--no-double-q turns off a preset-enabled boolean."""
    argv = ["island", "deep-q", "--preset", "--no-double-q"]
    args = apply_preset(prepare_parser().parse_args(argv), argv)
    assert args.double_q is False
    assert agent_kwargs(args)["double_q"] is False
    argv = ["island", "deep-q", "--preset"]
    args = apply_preset(prepare_parser().parse_args(argv), argv)
    assert args.double_q is True


def test_island_presets_hold_the_reference_values():
    """Island's deep-q and tabular-q presets, key for key the reference's
    (safe_grid_agents_tpu/cli/presets.yaml)."""
    argv = ["island", "tabular-q", "--preset"]
    args = apply_preset(prepare_parser().parse_args(argv), argv)
    assert (args.lr, args.epsilon_anneal_steps, args.n_envs, args.chunk_steps,
            args.steps) == (0.2, 30000, 64, 128, 100000)
    argv = ["island", "deep-q", "--preset"]
    args = apply_preset(prepare_parser().parse_args(argv), argv)
    assert (args.lr, args.epsilon_anneal_steps, args.epsilon_final, args.batch_size,
            args.replay_capacity, args.sync_every, args.n_envs, args.chunk_steps,
            args.steps, args.warmup_steps, args.double_q) == (
        0.0005, 2400000, 0.1, 128, 100000, 100, 256, 64, 3000000, 40, True)


def test_cli_island_tabular_preset_trains():
    """``island tabular-q ... --fused-kernel --preset`` parses and trains
    (two chunks of the preset's N=64, T=128 here)."""
    tk.counts.reset()
    stats = run(["island", "tabular-q", "--compiled", "--mxu", "--fused-kernel", "--preset",
                 "--steps", str(2 * 128 * 64)] + CPU)
    assert tk.counts.plain_calls == 2 and tk.counts.launches == 0
    assert stats["mean_length"] is not None


def test_cli_island_deep_q_preset_refused_under_fused_kernel():
    """The island deep-q preset's warmup of 40 steps is no multiple of the
    fused collect's 16-step record tile: refused, naming --warmup-steps."""
    with pytest.raises(SystemExit, match="--warmup-steps 40"):
        run(["island", "deep-q", "--compiled", "--mxu", "--fused-kernel", "--preset"] + CPU)
