"""``chip_smoke.py`` phase 11 (``safe_grid_agents_torch/tools/tool_cases.py``)
on the CPU at toy sizes: every tool in a fresh process through
``tools/counted.py``, the parts' checks met, the diag rows collected, and
no kernel launched (the CPU runs the plain versions)."""
from safe_grid_agents_torch.tools import tool_cases


def test_phase_11_runs_on_the_cpu():
    lines = []
    summary = tool_cases.card_phase("cpu", lines.append)
    parts = [k for k in summary if not k.startswith("_")]
    assert parts == ["sweep", "tune", "suite", "fuzz", "curves", "scale", "quickstart", "diag"]
    assert all(summary[p]["launches"] == {} for p in parts)
    assert summary["fuzz"]["transitions"] == 19 * 64 * 32
    assert [r["env"] for r in summary["suite"]["rows"]] == tool_cases.SUITE_ALIASES.split(",")
    assert sorted(summary["diag"]["subcommands"]) == sorted(tool_cases.DIAG_CARD)
    assert any(l.startswith("11. diag engine-pallas: pallas  N=64") for l in lines)
