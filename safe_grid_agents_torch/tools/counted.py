"""Run port tools in this process with every kernel's launch count set to 0
before each and reported after it.

    python -m safe_grid_agents_torch.tools.counted [--out FILE] [--after FILE] -- \\
        tools.sweep shift tabular-q ... [--- tools.diag engine-pallas ...]

Each group (separated by ``---``) names a module of the package and its
arguments; the module's ``main(args)`` runs as ``python -m
safe_grid_agents_torch.<module> ...`` would run it, one group after
another in this process. After
each, one line ``counted: {...}`` gives the module, its arguments, its wall
time, the launches of every kernel that launched (``agent_gates.
all_counts``) and the calls of every plain version that ran. A group that
exits non-zero stops the run with its exit code, after its line.
``--after FILE`` waits (after the imports) until FILE exists before the
first group runs: a process can start while others still use the card and
begin its own work once they are done.
``chip_smoke.py`` phase 11 starts each tool this way in a fresh process.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
import time

import torch

from .agent_gates import all_counts


def run_group(module: str, args: list) -> dict:
    counts = all_counts()
    for c in counts.values():
        c.reset()
    main = importlib.import_module(f"safe_grid_agents_torch.{module}").main
    t0 = time.perf_counter()
    code = 0
    try:
        main(list(args))
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        if code:
            print(e.code, file=sys.stderr, flush=True)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    rec = {"module": module, "args": list(args), "exit": code,
           "wall_s": time.perf_counter() - t0,
           "launches": {k: c.launches for k, c in counts.items() if c.launches},
           "plain_calls": {k: c.plain_calls for k, c in counts.items() if c.plain_calls}}
    print("counted: " + json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = after = None
    while argv[:1] in (["--out"], ["--after"]):
        if argv[0] == "--out":
            out = argv[1]
        else:
            after = argv[1]
        argv = argv[2:]
    if argv[:1] == ["--"]:
        argv = argv[1:]
    groups, cur = [], []
    for a in argv:
        if a == "---":
            groups.append(cur)
            cur = []
        else:
            cur.append(a)
    groups.append(cur)
    for module, *_ in groups:
        importlib.import_module(f"safe_grid_agents_torch.{module}")
    while after and not os.path.exists(after):
        time.sleep(0.05)
    records = []
    for g in groups:
        records.append(run_group(g[0], g[1:]))
        if out:
            with open(out, "w") as f:
                json.dump(records, f, indent=1)
        if records[-1]["exit"]:
            return records[-1]["exit"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
