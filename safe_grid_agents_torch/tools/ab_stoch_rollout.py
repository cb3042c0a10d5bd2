"""A/B timing of the stochastic rollout kernel B7 built from several
``csrc`` trees, in one process on one card.

    python -m safe_grid_agents_torch.tools.ab_stoch_rollout \\
        --variant old=path/to/old/csrc --variant new=safe_grid_agents_torch/csrc \\
        [--steps 32768] [--rounds 6] [--seeds 2] [--out ab_stoch_rollout.json]

Each variant's ``stoch_rollout_kernel.cu`` (with the headers beside it) is
compiled by nvcc with the package's flags, all variants in parallel
(``tools/variants.py``), and its machine code (``cuobjdump -sass``) hashed, so variants that compile to
the same code show one hash. Then, on absent, whisky, tomato and friend at
cap 127 (tables in device memory) at N = 4096, T = ``--steps`` (32768; the
main path runs 4096) from reset, and for each of ``--seeds`` stream draws,
the variants are timed in ``--rounds`` rounds whose order rotates (A B C,
then B C A, ...): one CUDA-event-timed call per variant per round, after
one warm-up call each. Every variant's outputs must equal the first's.
Prints a line per alias and seed, and one JSON object with every time and
the card's name and power limit (also written to ``--out``). ``ab_time`` is
the same A/B for a caller that has built the variants (``chip_smoke.py``'s
phase 5b).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time
from pathlib import Path

import torch

from ..envs import make_env
from ..ops import _build
from ..ops import stoch_rollout_kernel as srk
from . import variants as var
from .learner_cases import event_ms, nvidia_smi

CASES = (("absent", {}), ("whisky", {}), ("tomato", {}), ("friend", {"cap": 127}))
N = 4096


def build(variants: dict, out_dir: Path) -> dict:
    """``label -> variants.Built`` (with SASS) of every ``label -> csrc
    directory``'s ``stoch_rollout_kernel.cu``, compiled in parallel."""
    return var.build({label: Path(csrc) / "stoch_rollout_kernel.cu"
                      for label, csrc in variants.items()}, out_dir, sass=True)


def launcher(so: Path):
    fn = ctypes.CDLL(str(so)).stoch_rollout_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 7 + [I] * 8 + [P] * 9 + [I] * 2 + [P] * 9
    fn.restype = ctypes.c_int
    return fn


def launch(fn, tables, state, streams):
    """``srk.stoch_rollout`` (its checks and its call) with the variant's
    entry point in place of the package's build."""
    with var.swapped(srk, _fn=fn):
        return srk.stoch_rollout(tables, state, *streams)


def ab_time(dev, built: dict, steps: int, rounds: int, seeds: int) -> dict:
    """Median CUDA-event ms of each built variant (``build``'s result) on
    ``CASES`` at N = 4096, T = ``steps`` from reset, for each of ``seeds``
    stream draws, in ``rounds`` rounds of rotating order after one warm-up
    call each, every variant's outputs held equal to the first's."""
    fns = {label: launcher(b.so) for label, b in built.items()}
    labels = list(fns)
    result = {"N": N, "T": steps, "rounds": rounds,
              "sass": {k: b.digest for k, b in built.items()}, "cases": {}}
    for alias, kw in CASES:
        eng = srk.StochRolloutEngine(make_env(alias, compiled=True, device=dev, **kw), N)
        name = f"{alias}@{kw['cap']}" if kw else alias
        for seed in range(seeds):
            g = torch.Generator(device=dev).manual_seed(seed)
            state = eng.reset(g)
            streams = eng.draw_streams(g, steps)
            first = None
            for label in labels:  # one warm-up call each, outputs held equal
                outs = launch(fns[label], eng.tables, state, streams)
                torch.cuda.synchronize()
                if first is None:
                    first = outs
                elif not all(torch.equal(a, b) for a, b in zip(outs, first)):
                    raise AssertionError(
                        f"{name} seed {seed}: {label} differs from {labels[0]}")
            times = {label: [] for label in labels}
            for r in range(rounds):
                for label in labels[r % len(labels):] + labels[:r % len(labels)]:
                    ms, _ = event_ms(lambda: launch(fns[label], eng.tables, state, streams))
                    times[label].append(ms)
            place = srk.rollout_placement(eng.tables)
            result["cases"][f"{name} seed {seed}"] = {
                "placement": place, "ms": times,
                "median_ms": {k: statistics.median(v) for k, v in times.items()}}
            print(f"B7 {name:10s} T={steps} seed {seed} ({place}): " + "; ".join(
                f"{k} median {statistics.median(v):.4f} ms [{min(v):.4f} … {max(v):.4f}]"
                for k, v in times.items()), flush=True)
            del streams, first, outs
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", action="append", required=True, metavar="LABEL=CSRC",
                   help="a label and the csrc directory to build B7 from (repeatable)")
    p.add_argument("--steps", type=int, default=32768, help="T of every call")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--out", default=None, help="also write the JSON object here")
    args = p.parse_args(argv)
    variants = dict(v.split("=", 1) for v in args.variant)
    if not torch.cuda.is_available():
        raise SystemExit("ab_stoch_rollout: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    built = build(variants, _build.BUILD_DIR / "ab")
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.2f} s on {card}",
          flush=True)
    for label, b in built.items():
        print(f"{label}: SASS {b.digest}; {var.registers(b.report)}", flush=True)
    result = {"card": card, **ab_time(dev, built, args.steps, args.rounds, args.seeds)}
    result["clocks_after"] = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
