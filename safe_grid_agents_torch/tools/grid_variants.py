"""What holds the grid-wide learner routes back — B4's grid kernel
(``csrc/dqn_update_grid.cu``) and B6's wide kernel
(``csrc/ppo_wide_kernel.cu``), over ``csrc/tile_gemm.cuh`` — by taking parts
of their work away, on one card.

    python -m safe_grid_agents_torch.tools.grid_variants [--rounds 3] [--out grid.json]

Each variant is the three sources with one textual change (``VARIANTS``),
built with the package's nvcc flags into ``_build/grid_variants/`` (one
nvcc a kernel and variant, all started together) and launched through the
package's wrappers (``dqn_update``, ``ppo_optimize``) with the variant's
library in place of the package's; every variant is timed by its device
time (CUDA events behind a spin kernel, ``learner_cases.fenced_ms``) at the
shapes of the commands that take these routes (B4 at sokoban's hidden 512
and batch 4096, B6 at island's hidden 256), in rotating order. Variants
that drop work give wrong outputs on purpose: their time says what that
work costs, and their largest error against the plain version is printed
beside it. A substitution that no longer matches the source raises before
anything is built. Prints one JSON object (also written to ``--out``) with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops import dqn_update_kernel as duk
from ..ops import ppo_kernel as pk
from . import learner_cases as lc

HEADER, B4_SRC, B6_SRC = "tile_gemm.cuh", "dqn_update_grid.cu", "ppo_wide_kernel.cu"
_MMA_CALL = "    mma_chunk<kTA, kTB>(acc, As, As + kSlotA, wm0, wn0);"
_MMA3 = '''        if (lo) mma(part[mt][nt], alo[mt], bhi[nt]);
        mma(part[mt][nt], ahi[mt], blo[nt]);
'''
_COPIES = '''      stage<kBM>(a, m0, k0 + c * kKT, k1, va, slot);
      stage<kBN>(b, n0, k0 + c * kKT, k1, vb, slot + kSlotA);'''
_JOIN = "acc[mt][nt][q] = __fadd_rn(acc[mt][nt][q], part[mt][nt][q]);"
# name -> (what it changes, [(file, old, new), ...]); the first is as built.
VARIANTS = {
    "as built": ("the sources unchanged", []),
    "no products": ("the tiles' mma.sync products and fragment loads dropped (copies, "
                    "barriers and epilogues kept)",
                    [(HEADER, _MMA_CALL, "    if (false) " + _MMA_CALL.lstrip())]),
    "one product": ("hi·hi alone (1xTF32): two of the three mma.sync a product dropped",
                    [(HEADER, _MMA3, "")]),
    "no copies": ("no operand chunk copied into shared memory (the products run on what the "
                  "ring holds)", [(HEADER, _COPIES, "")]),
    "4-byte copies": ("every operand copied 4 bytes a copy (no 16-byte copies)",
                      [(HEADER, "const bool va = aligned16(a), vb = aligned16(b);",
                        "const bool va = false, vb = false;")]),
    "no chunk join": ("the mma.sync products accumulate into the tile's sums directly (no "
                      "round-to-nearest join a chunk)",
                      [(HEADER, "mma(part[mt][nt]", "mma(acc[mt][nt]"),
                       (HEADER, _JOIN, "(void)part;")]),
    "join a k-step": ("each k-step's three mma.sync go to a fresh accumulator that joins the "
                      "tile's sums in round-to-nearest at once (no chunk accumulator)",
                      [(HEADER, _MMA3 + "        mma(part[mt][nt], ahi[mt], bhi[nt]);\n",
                        "        float d[4] = {0.f, 0.f, 0.f, 0.f};\n"
                        "        if (lo) mma(d, alo[mt], bhi[nt]);\n"
                        "        mma(d, ahi[mt], blo[nt]);\n"
                        "        mma(d, ahi[mt], bhi[nt]);\n"
                        "#pragma unroll\n"
                        "        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = "
                        "__fadd_rn(acc[mt][nt][q], d[q]);\n"),
                       (HEADER, _JOIN, "(void)part;")]),
    "k-steps rolled": ("a chunk's four k-steps in a loop, not unrolled",
                       [(HEADER, "#pragma unroll\n  for (int ks = 0; ks < kKT / 8; ++ks) {",
                         "#pragma unroll 1\n  for (int ks = 0; ks < kKT / 8; ++ks) {")]),
    "ring of 4": ("four chunks in the copy ring, not two",
                  [(HEADER, "constexpr int kStages = 2;", "constexpr int kStages = 4;")]),
    "tile-major parts": ("a split-K job's items tile-major (every part of tile 0, then of "
                         "tile 1, ...), not part-major",
                         [(HEADER, "const int split = rest / tiles, tile = rest % tiles;",
                           "const int split = rest % j.splits, tile = rest / j.splits;")]),
    "no grid barriers": ("every grid barrier a block barrier (phases race; the work and the "
                         "launch are kept)",
                         [(B4_SRC, "grid.sync();", "__syncthreads();"),
                          (B6_SRC, "grid.sync();", "__syncthreads();")]),
    "one block an SM": ("one 256-thread block an SM (255 registers a thread, half the grid)",
                        [(HEADER, "constexpr int kBlocksPerSm = 2;",
                          "constexpr int kBlocksPerSm = 1;")]),
    "128-row tiles": ("128 × 64 output tiles (warps 32 × 32), one block an SM",
                      [(HEADER, "constexpr int kBlocksPerSm = 2;",
                        "constexpr int kBlocksPerSm = 1;"),
                       (HEADER, "constexpr int kBM = 64, kBN = 64;",
                        "constexpr int kBM = 128, kBN = 64;")]),
    "64 × 128 tiles": ("64 × 128 output tiles (warps 32 × 32), one block an SM",
                       [(HEADER, "constexpr int kBlocksPerSm = 2;",
                         "constexpr int kBlocksPerSm = 1;"),
                        (HEADER, "constexpr int kBM = 64, kBN = 64;",
                         "constexpr int kBM = 64, kBN = 128;")]),
}


def variant_sources(changes) -> dict:
    """``file -> text`` of the three sources with ``changes`` applied."""
    srcs = {f: (Path(_build.CSRC) / f).read_text() for f in (HEADER, B4_SRC, B6_SRC)}
    for f, old, new in changes:
        if old not in srcs[f]:
            raise ValueError(f"csrc/{f} no longer holds {old!r}")
        srcs[f] = srcs[f].replace(old, new)
    return srcs


def build_variants(out_dir: Path) -> dict:
    """``name -> (bound dqn_update_grid_launch, bound ppo_wide_launch)``."""
    sources = {name: variant_sources(changes) for name, (_, changes) in VARIANTS.items()}
    if out_dir.exists():
        shutil.rmtree(out_dir)
    procs = {}
    for i, (name, srcs) in enumerate(sources.items()):
        d = out_dir / f"v{i}"
        d.mkdir(parents=True)
        for f, text in srcs.items():
            (d / f).write_text(text)
        for src in (B4_SRC, B6_SRC):
            so = d / f"lib{Path(src).stem}.so"
            procs[(name, src)] = (subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(d / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (name, src), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r} of {src}:\n{log}")
        libs[(name, src)] = ctypes.CDLL(str(so))
    return {name: (duk.bind_grid(libs[(name, B4_SRC)]), pk.bind_wide(libs[(name, B6_SRC)]))
            for name in sources}


@contextlib.contextmanager
def libraries(b4_fn, b6_fn):
    """The wrappers launch ``b4_fn`` and ``b6_fn`` inside the block."""
    saved = duk._grid_lib, pk._wide_lib
    duk._grid_lib, pk._wide_lib = (lambda: b4_fn), (lambda: b6_fn)
    try:
        yield
    finally:
        duk._grid_lib, pk._wide_lib = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grid_variants: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    result = {"card": lc.nvidia_smi("name,power.limit"), "variants": {}}
    print(f"card {result['card']}", flush=True)
    fns = build_variants(Path(_build.BUILD_DIR) / "grid_variants")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for name in ("hidden512", "batch4096"):
        agent, xs = lc.dqn_case(name, dev, g)
        cases[f"b4 {name}"] = (lambda a=agent, x=xs: duk.dqn_update(a, *x),
                               duk.dqn_update_reference(agent, *xs))
    agent, xs = lc.ppo_case("island256", dev, g)
    cases["b6 island256"] = (lambda a=agent, x=xs: pk.ppo_optimize(a, *x),
                             pk.ppo_optimize_reference(agent, *xs))
    for case, (call, ref) in cases.items():
        times = {name: [] for name in fns}
        errs = {}
        for name, libs in fns.items():
            with libraries(*libs):
                out = call()
                torch.cuda.synchronize()
            errs[name] = max(float((a - b).abs().max()) for a, b in zip(
                lc.flat_tensors(out), lc.flat_tensors(ref)))
        order = list(fns)
        for r in range(args.rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                with libraries(*fns[name]):
                    times[name].append(lc.fenced_ms(call, reps=3))
        for name in fns:
            row = {"change": VARIANTS[name][0], "device_ms": statistics.median(times[name]),
                   "runs_ms": times[name], "max_abs_err": errs[name]}
            result["variants"].setdefault(name, {})[case] = row
            print(f"{case:13s} {name:17s} device {row['device_ms']:.4f} ms; max |err| vs plain "
                  f"{errs[name]:.3g} ({row['change']})", flush=True)
    result["clocks_after"] = lc.nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
