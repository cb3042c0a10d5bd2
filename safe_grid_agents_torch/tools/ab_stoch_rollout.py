"""A/B timing of the stochastic rollout kernel B7 built from several
``csrc`` trees, in one process on one card.

    python -m safe_grid_agents_torch.tools.ab_stoch_rollout \\
        --variant old=path/to/old/csrc --variant new=safe_grid_agents_torch/csrc \\
        [--rounds 6] [--seeds 2] [--out ab_stoch_rollout.json]

Each variant's ``stoch_rollout_kernel.cu`` (with the ``stoch_step.cuh``
beside it) is compiled by nvcc with the package's flags, all variants in
parallel, and its machine code (``cuobjdump -sass``) hashed, so variants
that compile to the same code show one hash. Then, on absent, whisky,
tomato and friend at cap 127 (tables in device memory) at N = 4096,
T = 32768 from reset, and for each of ``--seeds`` stream draws, the
variants are timed in ``--rounds`` rounds whose order rotates (A B C, then
B C A, ...): one CUDA-event-timed call per variant per round, after one
warm-up call each. Every variant's outputs must equal the first's. Prints
a line per alias and seed, and one JSON object with every time and the
card's name and power limit (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import torch

from ..envs import make_env
from ..ops import _build
from ..ops import stoch_rollout_kernel as srk
from .learner_cases import event_ms, nvidia_smi

CASES = (("absent", {}), ("whisky", {}), ("tomato", {}), ("friend", {"cap": 127}))
N, T = 4096, 32768


def build(variants: dict, out_dir: Path) -> dict:
    """Compile every variant in parallel; returns ``label -> (library path,
    ptxas report, SASS hash)``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for label, csrc in variants.items():
        so = out_dir / f"libstoch_rollout_kernel-{label}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(so),
               str(Path(csrc) / "stoch_rollout_kernel.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), so)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    built = {}
    for label, (proc, so) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {label}:\n{report}")
        sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                              check=True).stdout
        # Drop the lines that name the file, keep the code.
        code = "\n".join(line for line in sass.splitlines()
                         if not re.match(r"\s*(Fatbin|code for|arch|Function|=+|$)", line))
        built[label] = (so, report, hashlib.sha256(code.encode()).hexdigest()[:16])
    return built


def launcher(so: Path):
    fn = ctypes.CDLL(str(so)).stoch_rollout_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 7 + [I] * 8 + [P] * 9 + [I] * 2 + [P] * 9
    fn.restype = ctypes.c_int
    return fn


def launch(fn, tables, state, streams):
    """``srk.stoch_rollout`` (its checks and its call) with the variant's
    entry point in place of the package's build."""
    srk._lib = lambda: fn
    return srk.stoch_rollout(tables, state, *streams)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", action="append", required=True, metavar="LABEL=CSRC",
                   help="a label and the csrc directory to build B7 from (repeatable)")
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
    for label, (_, report, sass) in built.items():
        regs = re.findall(r"Used \d+ registers[^\n]*", report)
        print(f"{label}: SASS {sass}; {regs}", flush=True)
    fns = {label: launcher(so) for label, (so, _, _) in built.items()}
    labels = list(fns)
    result = {"card": card, "N": N, "T": T, "rounds": args.rounds,
              "sass": {k: v[2] for k, v in built.items()}, "cases": {}}
    for alias, kw in CASES:
        eng = srk.StochRolloutEngine(make_env(alias, compiled=True, device=dev, **kw), N)
        name = f"{alias}@{kw['cap']}" if kw else alias
        for seed in range(args.seeds):
            g = torch.Generator(device=dev).manual_seed(seed)
            state = eng.reset(g)
            streams = eng.draw_streams(g, T)
            first = None
            for label in labels:  # one warm-up call each, outputs held equal
                outs = launch(fns[label], eng.tables, state, streams)
                torch.cuda.synchronize()
                if first is None:
                    first = outs
                elif not all(torch.equal(a, b) for a, b in zip(outs, first)):
                    raise AssertionError(f"{name} seed {seed}: {label} differs from {labels[0]}")
            times = {label: [] for label in labels}
            for r in range(args.rounds):
                for label in labels[r % len(labels):] + labels[:r % len(labels)]:
                    ms, _ = event_ms(lambda: launch(fns[label], eng.tables, state, streams))
                    times[label].append(ms)
            result["cases"][f"{name} seed {seed}"] = {
                "placement": srk.placement(eng.tables), "ms": times,
                "median_ms": {k: statistics.median(v) for k, v in times.items()}}
            print(f"{name:10s} seed {seed} ({srk.placement(eng.tables)}): " + "; ".join(
                f"{k} median {statistics.median(v):.4f} ms [{min(v):.4f} … {max(v):.4f}]"
                for k, v in times.items()), flush=True)
            del streams, first, outs
    result["clocks_after"] = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
