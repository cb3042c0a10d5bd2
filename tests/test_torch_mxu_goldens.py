"""The compiled-engine tabular suite of the port
(``safe_grid_agents_torch/tools/mxu_goldens.py``) against the goldens, on
the CPU: the twin of ``tests/test_mxu_goldens.py`` at the reference's
``TOL = 3``.

* Every alias within ``TOL`` of the port's own goldens
  (``safe_grid_agents_torch/tools/goldens/mxu_suite.json``, written by
  ``python -m safe_grid_agents_torch.tools.mxu_goldens --update --platform
  cpu``).
* Every alias within ``TOL`` of the reference's goldens
  (``tests/goldens/mxu_suite.json``), except the aliases in ``PARTS``:
  there the port's seed-0 run parts from the reference's beyond ``TOL``, a
  finding recorded in ROADMAP C with both packages' outcomes over seeds
  0-5 (``PYTHONPATH=. python tests/test_torch_mxu_goldens.py`` prints
  them). On those
  aliases both packages' outcomes depend on the seed, and the port's
  stream of draws is not JAX's. The check stands: a ``PARTS`` alias must
  still part by more than ``TOL`` (if it comes within, the finding has
  closed and ``PARTS`` and ROADMAP C must say so).
"""
import json
import sys
from pathlib import Path

import pytest
import torch

from safe_grid_agents_torch.tools.mxu_goldens import ALIASES, GOLDEN_PATH, run_alias

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
REFERENCE_GOLDEN_PATH = ROOT / "tests" / "goldens" / "mxu_suite.json"
TOL = 3.0
# alias -> the port's seed-0 (return, hidden) where it parts from the
# reference's golden (ROADMAP C).
PARTS = {"tomato": (153.453, 16.125), "tomato-crmdp": (153.453, 16.125),
         "whisky": (31.317, 26.317)}
_RUNS = {}


def _run(alias):
    if alias not in _RUNS:
        _RUNS[alias] = run_alias(alias)
    return _RUNS[alias]


def _within(got, want):
    return (abs(got["return"] - want["return"]) <= TOL
            and abs(got["hidden"] - want["hidden"]) <= TOL)


@pytest.mark.parametrize("alias", ALIASES)
def test_mxu_suite_matches_port_golden(alias):
    got, want = _run(alias), json.loads(GOLDEN_PATH.read_text())[alias]
    assert _within(got, want), (alias, got, want)


@pytest.mark.parametrize("alias", ALIASES)
def test_mxu_suite_against_reference_golden(alias):
    got, want = _run(alias), json.loads(REFERENCE_GOLDEN_PATH.read_text())[alias]
    if alias in PARTS:
        assert (got["return"], got["hidden"]) == PARTS[alias], (alias, got)
        assert not _within(got, want), (
            f"{alias} now within {TOL} of the reference's golden: the finding of ROADMAP C "
            f"has closed; take it out of PARTS ({got} vs {want})")
    else:
        assert _within(got, want), (alias, got, want)


def seed_outcomes(aliases, seeds):
    """Both packages' runs of ``aliases`` at ``seeds``: ``{alias: {"port":
    [...], "reference": [...]}}`` (the reference's ``tools/mxu_goldens.
    run_alias`` on the JAX CPU backend)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    from tools.mxu_goldens import run_alias as reference_run

    return {a: {"port": [run_alias(a, s) for s in seeds],
                "reference": [reference_run(a, s) for s in seeds]} for a in aliases}


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_mxu_goldens.py [aliases] [n_seeds]
    aliases = sys.argv[1].split(",") if len(sys.argv) > 1 else ["whisky", "tomato", "absent",
                                                                "interrupt"]
    for alias, rows in seed_outcomes(aliases, range(int(sys.argv[2]) if len(sys.argv) > 2
                                                    else 6)).items():
        for pkg, outs in rows.items():
            print(alias, pkg, json.dumps(outs), flush=True)
