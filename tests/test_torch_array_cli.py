"""The port's CLI and base trainers on the reference's own gates, on the CPU.

The reference's default entry point (``shift tabular-q`` with no engine
flag) runs on the array engine; the gates are those of
``tests/test_cli.py:60``, ``:74``, ``:222``, ``:238``, ``:329`` and
``tests/test_agents.py:74``, ``:150``, with their flags and thresholds.
The friend family's tabular runs go to the array engine, and both compiled
paths refuse them (``tests/test_friend_compiled.py:103``).
"""
import json

import numpy as np
import pytest
import torch

from safe_grid_agents_torch.agents.dummy import RandomAgent
from safe_grid_agents_torch.agents.tabular import TabularQAgent
from safe_grid_agents_torch.cli.main import run
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.array_vec import ArrayVecEnv
from safe_grid_agents_torch.training import (
    DummyTrainer, TabularQTrainer, stats_to_host,
)

torch.set_num_threads(1)
CPU = ["--platform", "cpu"]


def test_cli_default_entry_point_reaches_the_shift_optimum():
    """``python -m safe_grid_agents_torch shift tabular-q --lr 0.2``: N = 128,
    500 k steps, on the array engine."""
    stats = run(["shift", "tabular-q", "--lr", "0.2"] + CPU)
    assert stats["mean_return"] > 38.0, stats


def test_cli_end_to_end_tabular(tmp_path):  # tests/test_cli.py:60
    stats = run(["shift", "tabular-q", "--n-envs", "64", "--steps", "60000",
                 "--chunk-steps", "128", "--eval-every", "4", "--eval-steps", "30",
                 "--lr", "0.2", "--epsilon-anneal-steps", "20000",
                 "--log-dir", str(tmp_path / "logs")] + CPU)
    assert stats["mean_return"] > 38.0, stats
    recs = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [r["prefix"] for r in recs][-2:] == ["train", "eval"]


def test_cli_cheat_flag_trains_on_hidden():  # tests/test_cli.py:74
    # Island + cheat: water costs −50 during training, so the agent learns to
    # reach the goal instead of drowning.
    stats = run(["island", "tabular-q", "--cheat", "--n-envs", "64", "--steps", "80000",
                 "--chunk-steps", "128", "--eval-every", "100", "--eval-steps", "40",
                 "--lr", "0.2", "--epsilon-anneal-steps", "30000"] + CPU)
    assert stats["mean_hidden"] > 40.0, stats


def test_cli_eval_env_distributional_shift():  # tests/test_cli.py:222
    stats = run(["shift", "tabular-q", "--n-envs", "64", "--steps", "60000",
                 "--chunk-steps", "128", "--eval-every", "100", "--eval-steps", "30",
                 "--lr", "0.2", "--epsilon-anneal-steps", "20000",
                 "--eval-env", "shift-test"] + CPU)
    assert stats["mean_return"] < -40.0, stats
    assert stats["mean_length"] < 8.0


def test_preset_flag():  # tests/test_cli.py:238
    stats = run(["shift", "tabular-q", "--preset", "--steps", "40000"] + CPU)
    assert stats["mean_return"] > 38.0, stats


def test_cli_mxu_tabular_end_to_end(tmp_path):  # tests/test_cli.py:329
    stats = run(["shift", "tabular-q", "--compiled", "--mxu", "--n-envs", "64",
                 "--steps", "60000", "--chunk-steps", "128", "--eval-every", "4",
                 "--eval-steps", "30", "--lr", "0.2", "--epsilon-anneal-steps", "20000",
                 "--log-dir", str(tmp_path / "logs")] + CPU)
    assert stats["mean_return"] > 38.0, stats
    assert (tmp_path / "logs" / "metrics.jsonl").exists()


def test_tabular_learns_shift_optimal():  # tests/test_agents.py:74
    env = make_env("shift")
    vec = ArrayVecEnv(env, 64, device="cpu")
    trainer = TabularQTrainer(TabularQAgent(env, lr=0.2, epsilon_anneal_steps=20_000), vec)
    gen = torch.Generator().manual_seed(1)
    astate, vstate = trainer.init(torch.Generator().manual_seed(0))
    evals = []
    for i in range(10):
        astate, vstate, _ = trainer.train_chunk(astate, vstate, gen, 128)
        if i >= 7:
            _, es = trainer.eval_chunk(astate, vec.reset(), 30)
            evals.append(stats_to_host(es)["mean_return"])
    assert max(evals) == 40.0, evals


def test_random_agent_plumbing():  # tests/test_agents.py:150
    env = make_env("boat")
    vec = ArrayVecEnv(env, 32, device="cpu")
    trainer = DummyTrainer(RandomAgent(env), vec)
    astate, vstate = trainer.init()
    astate, vstate, stats = trainer.train_chunk(astate, vstate,
                                                torch.Generator().manual_seed(1), 120)
    s = stats_to_host(stats)
    assert s["episodes"] >= 32  # 100-step limit: every env finished once
    assert s["env_steps"] == 120 * 32


@pytest.mark.parametrize("flags", [["--compiled"], ["--compiled", "--mxu"],
                                   ["--compiled", "--mxu", "--fused-kernel"]])
def test_friend_tabular_is_refused_on_both_compiled_paths(flags):
    """tests/test_friend_compiled.py:103: the compiled index encodes the
    hidden reward box; the refusal sends the user to the array engine."""
    with pytest.raises(SystemExit, match="hidden") as exc:
        run(["friend", "tabular-q", *flags, "--n-envs", "4", "--steps", "64"] + CPU)
    assert "drop --compiled" in str(exc.value)


@pytest.mark.parametrize("alias", ["friend", "neutral", "foe"])
def test_friend_family_tabular_runs_on_the_array_engine(alias):
    stats = run([alias, "tabular-q", "--n-envs", "32", "--steps", "8192", "--chunk-steps",
                 "64", "--lr", "0.2"] + CPU)
    # 120 eval steps: every lane ends an episode, by the 100-step timeout at the latest.
    assert stats["env_steps"] == 120 * 32 and stats["episodes"] >= 32
    assert stats["mean_return"] == stats["mean_hidden"], stats  # hidden = observed here


@pytest.mark.parametrize("argv", [
    ["boat", "random"], ["boat", "single", "--compiled"],
    ["sokoban2", "random", "--compiled"]])
def test_dummy_agents_run_on_the_array_engine(argv):
    stats = run(argv + ["--n-envs", "8", "--steps", "1024", "--eval-steps", "100"] + CPU)
    assert stats["episodes"] >= 8 and stats["env_steps"] == 800


def test_prioritized_dqn_runs_on_the_array_engine():
    """``sokoban deep-q --prioritized`` (once refused, ROADMAP A.9): the base
    ``DQNTrainer`` with the agent's PER ring."""
    stats = run(["sokoban", "deep-q", "--prioritized", "--n-envs", "16", "--steps", "1024",
                 "--chunk-steps", "16", "--warmup-steps", "16", "--batch-size", "32",
                 "--updates-per-chunk", "4", "--eval-steps", "100"] + CPU)
    assert stats["env_steps"] == 100 * 16 and np.isfinite(stats["mean_return"])


@pytest.mark.parametrize("argv, match", [
    (["boat", "random", "--compiled", "--mxu"], "--mxu requires --compiled and one of"),
    (["boat", "single", "--mxu"], "--mxu requires --compiled and one of"),
    (["sokoban2", "tabular-q", "--compiled", "--mxu", "--fused-kernel"], "array engine"),
    (["shift", "tabular-q", "--n-devices", "2", "--tp", "2"], "needs a deep agent"),
    (["corners", "ppo-crmdp", "--cheat"], "observed"),
    (["shift", "tabular-q", "--table-net", "--compiled"], "table-net"),
])
def test_array_engine_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        run(argv + CPU)
