"""The port's CLI: the main path end to end on the CPU, and refusals.

``run`` drives ``shift tabular-q --compiled --mxu --fused-kernel`` through
the fused trainer (its plain kernel version on the CPU) and must reach the
shift optimum; every combination the port does not run yet must raise
``SystemExit`` naming what is missing.
"""
import json

import pytest
import torch

from safe_grid_agents_torch.cli.main import run
from safe_grid_agents_torch.ops import tabular_kernel as tk

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
    (MAIN + ["--eval-env", "absent"], "A.11"),
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
