"""Seed / hyperparameter sweep over the port's CLI: the counterpart of the
repo's ``tools/sweep.py``, with the same lines out.

    python -m safe_grid_agents_torch.tools.sweep shift tabular-q --steps 60000 \\
        --sweep seed=0,1,2 --sweep lr=0.1,0.2 [--platform cpu]

Every ``--sweep flag=v1,v2,...`` is a dimension; each combination runs
``cli.main.run`` in this process with the other arguments passed through
(``--platform`` among them: ``cuda:0`` unless ``--platform cpu``, no
fallback). One JSON line a run (the values as given, then the final eval,
NaN as ``null``), and last ``best by mean_return:`` with the best line (a
run with no finished eval episode ranks worst).
"""
from __future__ import annotations

import itertools
import json
import sys

from ..cli.main import run
from ..device import platform_device, platform_in


def rounded(stats: dict, digits: int) -> dict:
    """``stats`` rounded, NaN (no finished eval episode) as ``None``."""
    return {k: (None if v != v else round(v, digits)) for k, v in stats.items()}


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else list(argv)
    sweeps, passthrough = [], []
    i = 0
    while i < len(argv):
        if argv[i] == "--sweep":
            name, _, vals = argv[i + 1].partition("=")
            sweeps.append((name, vals.split(",")))
            i += 2
        else:
            passthrough.append(argv[i])
            i += 1
    if not sweeps:
        print("usage: python -m safe_grid_agents_torch.tools.sweep <cli args> "
              "--sweep flag=v1,v2 [--sweep ...]")
        sys.exit(2)
    platform_device(platform_in(passthrough))

    names = [n for n, _ in sweeps]
    results = []
    for combo in itertools.product(*[v for _, v in sweeps]):
        extra = []
        for n, v in zip(names, combo):
            extra += [f"--{n}", v]
        rec = {**dict(zip(names, combo)), **rounded(run(passthrough + extra), 3)}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    def score(r):
        v = r.get("mean_return")
        return float("-inf") if v is None else v

    best = max(results, key=score)
    print("best by mean_return:", json.dumps(best))
    return results


if __name__ == "__main__":
    main()
