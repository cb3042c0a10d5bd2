"""Learning curves of the port (``safe_grid_agents_torch/tools/curves.py``)
against the stored seed bands, on the CPU: the twin of
``tests/test_curves.py``. Each config's seed-0 curve must land inside the
reference's stored band (``tests/goldens/curves.json``, seeds 0-2) ± the
reference's ``TOL`` and inside the port's own stored band
(``safe_grid_agents_torch/tools/goldens/curves.json``, written by
``python -m safe_grid_agents_torch.tools.curves --update --platform cpu``)
± ``TOL``: the best eval return and the final hidden performance."""
import json

import pytest
import torch

from safe_grid_agents_torch.tools.curves import (
    CONFIGS, GOLDEN_PATH, REFERENCE_GOLDEN_PATH, TOL, band_check, collect_curve,
)

torch.set_num_threads(1)
_CURVES = {}


def _curve(cfg):
    if cfg["name"] not in _CURVES:
        _CURVES[cfg["name"]] = collect_curve(cfg, seed=0, device="cpu")
    return _CURVES[cfg["name"]]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_curve_within_reference_seed_band(cfg):
    c = band_check(cfg["name"], _curve(cfg), json.loads(REFERENCE_GOLDEN_PATH.read_text()))
    assert c["ok"], f"{cfg['name']}: {c}"


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_curve_within_port_seed_band(cfg):
    stored = json.loads(GOLDEN_PATH.read_text())
    assert sorted(stored[cfg["name"]]) == ["0", "1", "2"]
    c = band_check(cfg["name"], _curve(cfg), stored)
    assert c["ok"], f"{cfg['name']}: {c}"
    # The CPU run repeats: seed 0 is the stored seed-0 curve.
    assert _curve(cfg) == stored[cfg["name"]]["0"]
