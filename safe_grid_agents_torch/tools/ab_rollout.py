"""A/B timing of the rollout kernel B1 built from several ``csrc`` trees,
and what a step of it costs, in one process on one card.

    python -m safe_grid_agents_torch.tools.ab_rollout \\
        --variant parent=_archive/parent/safe_grid_agents_torch/csrc \\
        --variant new=safe_grid_agents_torch/csrc \\
        [--steps 4096,32768] [--rounds 6] [--lanes 32,128] [--stamps] \\
        [--parts] [--sass-dir DIR] [--out ab_rollout.json]

Each variant's ``rollout_kernel.cu`` (with the headers beside it) is
compiled by nvcc with the package's flags, all variants in parallel
(``tools/variants.py``), and its machine code (``cuobjdump -sass``) hashed; ``--sass-dir`` also writes
each variant's SASS and a count of its instructions by opcode there. Every
variant is launched through this tree's wrapper (``ops/rollout_kernel.py``:
its checks, its carved output buffer and its call), the C entry point being
the same in all of them. On shift at N = 4096 from reset, at each T of
``--steps`` (the main path runs 4096), the variants are timed in
``--rounds`` rounds whose order rotates (one CUDA-event-timed call per
variant per round, after one warm-up call each), every variant's outputs
held equal to the first's and to the plain version's.

``--lanes`` also times every variant at those N (T = the first of
``--steps``), which shows what one warp alone on an SM (N = 32), and one
block of the first design (N = 128), cost a step. ``--stamps`` builds the
last variant with ``-DSGA_TRACE`` (thread 0 of block 0 records
``clock64()`` at every action tile) and reports the cycles of a tile and
of a step at N = 4096. ``--parts`` builds the last variant's source with
parts of its work taken away or changed (``PARTS``: only the chain of
loads, no episode sums, no time limit, no action copies in the loop, other
tile depths) and times them beside it by device time, the outputs of those
that drop work wrong on purpose. Prints a line per case and one JSON object
with every time and the card's name and power limit (also written to
``--out``). ``ab_time`` is the same A/B for a caller that has built the
variants (``chip_smoke.py``'s phase 5b).
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
from ..ops import rollout_kernel as rk
from . import variants as var
from .learner_cases import event_ms, fenced_ms, nvidia_smi

N = 4096
ALIAS = "shift"

_STEP_SUMS = '''        epr = __fadd_rn(epr, r);
        eph = __fadd_rn(eph, __uint_as_float(e.z));
        epl += 1;
        racc = __fadd_rn(racc, r);
        eacc = __fadd_rn(eacc, dx);
        facc = __fadd_rn(facc, __fmul_rn(dx, epr));
'''
_STEP_SELECT = ("        at = timeout ? reset_row : (int)e.x;"
                "  // a done entry's successor is the reset\n")
_STEP_RESETS = '''        t = done ? 0 : t1;
        epr = done ? 0.f : epr;
        eph = done ? 0.f : eph;
        epl = done ? 0 : epl;
'''
_CHAIN_ONLY = [(_STEP_SUMS, ""), (_STEP_SELECT, "        at = (int)e.x;\n"),
               (_STEP_RESETS, "")]
_TILE = "constexpr int kTile = 128;"
_NO_COPIES = [("    if (s0 + kTile < T) {  // the next tile, into the other buffer\n"
               "      stage::stream(s_in + (cur ^ 1) * kTile * kThreads, actions, s0 + kTile,\n"
               "                    min(kTile, T - s0 - kTile), lane0, n_live, N, vec16);\n"
               "      stage::commit();\n"
               "    }\n", ""),
              ("    const uint32_t* in = s_in + cur * kTile * kThreads + threadIdx.x;",
               "    const uint32_t* in = s_in + threadIdx.x;")]
# name -> (what it changes, [(old, new), ...]) on the source of the last variant.
PARTS = {
    "as built": ("the source unchanged", []),
    "chain only": ("a step is the table load and the next position alone (at = its successor)",
                   _CHAIN_ONLY),
    "no episode sums": ("the five float adds and the length count dropped",
                        [(_STEP_SUMS, "")]),
    "no time limit": ("the next position is the successor alone (the select and the step "
                      "counter's chain dropped)",
                      [(_STEP_SELECT, "        at = (int)e.x;\n")]),
    "no tile copies": ("every tile walks the first tile's actions again (no copy in the loop)",
                       _NO_COPIES),
    "no tile copies, chain only": ("both of those", _NO_COPIES + _CHAIN_ONLY),
    "tiles of 16": ("16-step action tiles", [(_TILE, "constexpr int kTile = 16;")]),
    "tiles of 16, chain only": ("16-step tiles, the chain alone",
                                [(_TILE, "constexpr int kTile = 16;")] + _CHAIN_ONLY),
    "tiles of 64": ("64-step action tiles", [(_TILE, "constexpr int kTile = 64;")]),
    "tiles of 256": ("256-step action tiles", [(_TILE, "constexpr int kTile = 256;")]),
}


def build(sources: dict, out_dir: Path, flags=()) -> dict:
    """``label -> variants.Built`` (with SASS) of every ``label -> .cu
    path``, compiled in parallel."""
    return var.build(sources, out_dir, flags, sass=True)


def part_sources(cu: Path, out_dir: Path) -> dict:
    """``name -> .cu path`` of each of ``PARTS`` applied to ``cu``; raises
    if a substitution no longer matches the source."""
    cu = Path(cu)
    paths = var.write_variants(
        [cu.name], {name: [(cu.name, old, new) for old, new in changes]
                    for name, (_, changes) in PARTS.items()}, out_dir, csrc=cu.parent)
    return {name: p[cu.name] for name, p in paths.items()}


def launch(fn, tables, state, actions):
    """``rk.rollout`` (its checks, its carved buffer and its call) with the
    variant's entry point in place of the package's build."""
    with var.swapped(rk, _fn=fn):
        return rk.rollout(tables, state, actions)


def ab_time(dev, built: dict, steps: int, rounds: int, n: int = N, seed: int = 0) -> dict:
    """Median CUDA-event ms of each built variant (``build``'s result) on
    shift at ``n`` lanes and T = ``steps`` from reset, in ``rounds`` rounds
    of rotating order after one warm-up call each, every variant's outputs
    held equal to the first's and to the plain version's."""
    fns = {label: rk.bind(ctypes.CDLL(str(b.so))) for label, b in built.items()}
    labels = list(fns)
    eng = rk.RolloutEngine(make_env(ALIAS, compiled=True, device=dev), n)
    g = torch.Generator(device=dev).manual_seed(seed)
    state = eng.reset()
    actions = torch.randint(0, eng.A, (steps, n), dtype=torch.int32, generator=g, device=dev)
    ref = rk.rollout_reference(eng.tables, state, actions)
    for label in labels:  # one warm-up call each, outputs held equal
        outs = launch(fns[label], eng.tables, state, actions)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
            raise AssertionError(f"B1 N={n} T={steps}: {label} differs from the plain version")
    times = {label: [] for label in labels}
    for r in range(rounds):
        for label in labels[r % len(labels):] + labels[:r % len(labels)]:
            ms, _ = event_ms(lambda: launch(fns[label], eng.tables, state, actions))
            times[label].append(ms)
    result = {"N": n, "T": steps, "rounds": rounds, "ms": times,
              "median_ms": {k: statistics.median(v) for k, v in times.items()},
              "sass": {k: b.digest for k, b in built.items()}}
    print(f"B1 {ALIAS} N={n} T={steps}: " + "; ".join(
        f"{k} median {statistics.median(v):.4f} ms [{min(v):.4f} … {max(v):.4f}]"
        for k, v in times.items()) + " (outputs equal to the plain version's)", flush=True)
    return result


def stamps(dev, so: Path, steps: int) -> dict:
    """Cycles of an action tile (``rk.TILE`` steps) of thread 0 of block 0
    from a ``-DSGA_TRACE`` build, at N = 4096 on shift, T = ``steps``."""
    lib = ctypes.CDLL(str(so))
    fn = rk.bind(lib)
    eng = rk.RolloutEngine(make_env(ALIAS, compiled=True, device=dev), N)
    g = torch.Generator(device=dev).manual_seed(0)
    state = eng.reset()
    actions = torch.randint(0, eng.A, (steps, N), dtype=torch.int32, generator=g, device=dev)
    launch(fn, eng.tables, state, actions)
    torch.cuda.synchronize()
    ms, _ = event_ms(lambda: launch(fn, eng.tables, state, actions))
    tiles = -(-steps // rk.TILE)
    buf = (ctypes.c_longlong * (tiles + 1))()
    read = lib.rollout_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    if read(ctypes.addressof(buf), tiles + 1) != 0:
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    per_tile = [buf[i + 1] - buf[i] for i in range(tiles)]
    full = per_tile[:steps // rk.TILE]
    result = {"T": steps, "ms_stamped": ms, "tiles": tiles,
              "median_cycles_per_tile": statistics.median(full),
              "median_cycles_per_step": statistics.median(full) / rk.TILE,
              "min_cycles_per_tile": min(full), "max_cycles_per_tile": max(full),
              "loop_cycles": buf[tiles] - buf[0]}
    print(f"B1 stamps N={N} T={steps}: {ms:.4f} ms a stamped call; a {rk.TILE}-step tile median "
          f"{result['median_cycles_per_tile']:.0f} cycles [{min(full)} … {max(full)}], "
          f"{result['median_cycles_per_step']:.1f} a step; the loop {result['loop_cycles']} "
          "cycles", flush=True)
    return result


def time_parts(dev, built: dict, steps: int, rounds: int) -> dict:
    """Device ms (``fenced_ms``) of each part variant at N = 4096, T =
    ``steps``, in alternating order."""
    fns = {label: rk.bind(ctypes.CDLL(str(b.so))) for label, b in built.items()}
    eng = rk.RolloutEngine(make_env(ALIAS, compiled=True, device=dev), N)
    g = torch.Generator(device=dev).manual_seed(0)
    state = eng.reset()
    actions = torch.randint(0, eng.A, (steps, N), dtype=torch.int32, generator=g, device=dev)
    times = {label: [] for label in fns}
    order = list(fns)
    for r in range(rounds):
        for label in order if r % 2 == 0 else order[::-1]:
            times[label].append(
                fenced_ms(lambda fn=fns[label]: launch(fn, eng.tables, state, actions)))
    result = {}
    for label, v in times.items():
        result[label] = {"change": PARTS[label][0], "device_ms": statistics.median(v),
                         "runs_ms": v, "cycles_per_step_at_1980MHz":
                         statistics.median(v) * 1.98e6 / steps}
        print(f"B1 part {label:16s}: device {result[label]['device_ms']:.4f} ms "
              f"({PARTS[label][0]})", flush=True)
    return result


def sass_summary(b: var.Built) -> dict:
    ops = var.opcode_counts(b.sass)
    return {"hash": b.digest, "registers": var.registers(b.report),
            "instructions": sum(ops.values()), "opcodes": ops}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", action="append", required=True, metavar="LABEL=CSRC",
                   help="a label and the csrc directory to build B1 from (repeatable)")
    p.add_argument("--steps", default="4096,32768", help="comma-separated T of the A/B")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--lanes", default="", help="comma-separated extra N, at the first T")
    p.add_argument("--stamps", action="store_true")
    p.add_argument("--parts", action="store_true")
    p.add_argument("--sass-dir", default=None)
    p.add_argument("--out", default=None, help="also write the JSON object here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_rollout: no CUDA device is visible")
    variants = dict(v.split("=", 1) for v in args.variant)
    steps = [int(x) for x in args.steps.split(",") if x]
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    out_dir = Path(_build.BUILD_DIR) / "ab_rollout"
    t0 = time.perf_counter()
    sources = {label: Path(csrc) / "rollout_kernel.cu" for label, csrc in variants.items()}
    built = build(sources, out_dir)
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.2f} s on {card}",
          flush=True)
    result = {"card": card, "sass": {}, "ab": {}}
    for label, b in built.items():
        result["sass"][label] = sass_summary(b)
        print(f"{label}: SASS {b.digest}; {result['sass'][label]['registers']}; "
              f"{result['sass'][label]['instructions']} instructions", flush=True)
        if args.sass_dir:
            Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
            (Path(args.sass_dir) / f"b1_{label}.sass").write_text(b.sass)
    for T in steps:
        result["ab"][f"T={T}"] = ab_time(dev, built, T, args.rounds)
    for n in (int(x) for x in args.lanes.split(",") if x):
        result["ab"][f"N={n} T={steps[0]}"] = ab_time(dev, built, steps[0], args.rounds, n=n)
    last = list(sources.values())[-1]
    if args.stamps:
        traced = build({"traced": last}, out_dir / "traced", flags=("-DSGA_TRACE",))
        result["stamps"] = {f"T={T}": stamps(dev, traced["traced"].so, T) for T in steps}
    if args.parts:
        parts = build(part_sources(last, out_dir / "parts" / "src"), out_dir / "parts")
        for label, b in parts.items():
            result["sass"][f"part {label}"] = sass_summary(b)
            if args.sass_dir:
                (Path(args.sass_dir) / f"b1_part_{var.slug(label)}.sass").write_text(b.sass)
        result["parts"] = {f"T={T}": time_parts(dev, parts, T, args.rounds) for T in steps}
    result["clocks_after"] = nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
