"""SIGKILL, then ``--resume``: the port's twin of
``tests/test_fault_tolerance.py:89`` at its two configs (``:35-56``).

A CLI process (``python -m safe_grid_agents_torch ... --platform cpu``) is
killed with SIGKILL once a step at or past the kill point is committed,
possibly in the middle of writing a later one; relaunched with
``--resume`` it picks the newest readable step and ends in the
uninterrupted run's final state, bitwise: params, optimizer moments,
lanes and the generator's state
(``safe_grid_agents_torch/tools/resume_gates.py::sigkill_twin``, which
``chip_smoke.py`` phase 8 runs on the card on the fused tabular path).
Every subprocess has a timeout.
"""
import pytest

from safe_grid_agents_torch.tools.resume_gates import KILL_CONFIGS, sigkill_twin

pytestmark = pytest.mark.slow  # as the reference's: subprocesses, tens of seconds each


@pytest.mark.parametrize("config", ["tabular", "ppo-mxu"])
def test_sigkill_resume_bitwise(tmp_path, config):
    out = sigkill_twin(config, tmp_path, "cpu", timeout=300)
    _, n_chunks, kill_at, _ = KILL_CONFIGS[config]
    assert kill_at <= out["killed_at"] < n_chunks
    assert out["leaves"] > 0
