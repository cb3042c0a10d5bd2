"""What the device-memory placement of B1, B2, B3 and B5 costs over the
shared-memory one on the same inputs: each kernel launched on aliases whose
tables fit shared memory, once as built and once with its wrapper's
``placement`` forced to ``"global"`` (the launch entry points take the
device-memory route for any shape), both held bitwise to the plain version,
timed in alternating rounds (CUDA-event ms with the launch path, and device
ms behind a spin kernel). Run on the card:

    python -m safe_grid_agents_torch.tools.placement_cost [--rounds 8] [--out FILE]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

import torch

from ..envs import make_env
from ..ops import dqn_kernel as dk
from ..ops import ppo_collect_kernel as pck
from ..ops import rollout_kernel as rk
from ..ops import tabular_kernel as tk
from . import learner_cases as lc
from . import placement_cases as pc
from .variants import swapped

CLOCK_HZ = 1.98e9  # the H100's SM clock under load (nvidia-smi after timing)


def cases(dev, g):
    """``name -> (module, call, plain, steps)``: the kernel's wrapper call and
    plain call on the same inputs, and the lane-steps of one lane's walk."""
    out = {}
    eng = rk.RolloutEngine(make_env("shift", compiled=True, device=dev), 4096)
    st = eng.reset()
    acts = torch.randint(0, eng.A, (4096, 4096), dtype=torch.int32, generator=g, device=dev)
    out["B1 shift N=4096 T=4096"] = (rk, lambda: rk.rollout(eng.tables, st, acts),
                                     lambda: rk.rollout_reference(eng.tables, st, acts), 4096)
    for n, T in ((64, 128), (4096, 1024)):
        args = lc.tabq_edge_case("shift", n, T, "hot", dev, g)
        out[f"B2 shift N={n} T={T}"] = (tk, lambda a=args: tk.tabq(*a),
                                        lambda a=args: tk.tabq_reference(*a), T)
    for n, T in ((128, 32), (4096, 4096)):
        tr = pc.dqn_trainer("sokoban", n, dev)
        args = (tr.tables, tr.hyper,
                torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g, device=dev),
                tr.init()[1], torch.tensor([20_000], dtype=torch.int64, device=dev),
                torch.randint(0, tr.A, (T, n), dtype=torch.int32, generator=g, device=dev),
                torch.rand((T, n), generator=g, device=dev))
        out[f"B3 sokoban N={n} T={T}"] = (dk, lambda a=args: dk.dqn_collect(*a),
                                          lambda a=args: dk.dqn_collect_reference(*a), T)
    for alias, n, T in (("island", 1024, 64), ("sokoban", 4096, 1024)):
        tr = pc.ppo_trainer(alias, n, dev)
        astate, vstate = tr.init(seed=3)
        args = (tr.tables, tr.policy_rows(astate.params),
                tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                        vstate.ep_hidden, vstate.ep_len)),
                torch.rand((T, n), generator=g, device=dev))
        out[f"B5 {alias} N={n} T={T}"] = (pck, lambda a=args: pck.ppo_collect(*a),
                                          lambda a=args: pck.ppo_collect_reference(*a), T)
    return out


def placed(mod, label: str):
    """A block in which ``mod``'s wrapper takes the placement ``label``:
    as built (``"shared"`` on these inputs), or forced to ``"global"``."""
    if label == "global":
        return swapped(mod, placement=lambda *a: "global")
    return contextlib.nullcontext()


def measure(dev, rounds: int, log=print) -> dict:
    g = torch.Generator(device=dev).manual_seed(5)
    result = {}
    for name, (mod, call, plain, steps) in cases(dev, g).items():
        ref = plain()
        for label in ("shared", "global"):
            with placed(mod, label):
                if not lc.outputs_equal(call(), ref):
                    raise AssertionError(f"{name}: {label} differs from the plain version")
        ev = {"shared": [], "global": []}
        devms = {"shared": [], "global": []}
        for r in range(rounds):
            for label in (("shared", "global") if r % 2 == 0 else ("global", "shared")):
                with placed(mod, label):
                    ev[label].append(lc.event_ms(call)[0])
                    devms[label].append(lc.fenced_ms(call))
        row = {}
        for label in ("shared", "global"):
            d = statistics.median(devms[label])
            row[label] = {"event_ms": statistics.median(ev[label]), "device_ms": d,
                          "cycles_per_step": d * 1e-3 * CLOCK_HZ / steps}
        row["device_ratio"] = row["global"]["device_ms"] / row["shared"]["device_ms"]
        result[name] = row
        log(f"{name}: shared {row['shared']['event_ms']:.4f} ms (device "
            f"{row['shared']['device_ms']:.4f}, {row['shared']['cycles_per_step']:.0f} cycles a "
            f"step); device memory {row['global']['event_ms']:.4f} ms (device "
            f"{row['global']['device_ms']:.4f}, {row['global']['cycles_per_step']:.0f}); x"
            f"{row['device_ratio']:.2f} (both bitwise the plain version's)", flush=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    result = measure(torch.device("cuda", 0), args.rounds)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
