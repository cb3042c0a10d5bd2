"""What holds the actor-critic forward (B11, ``csrc/fused_mlp.cu``) back, by
taking parts of its work away, on one card.

    python -m safe_grid_agents_torch.tools.b11_variants [--rounds 4] [--out b11.json]

Each variant is the kernel's source with one textual change (``VARIANTS``),
built with the package's nvcc flags into ``_build/variants/`` (one nvcc
each, all started together, ``tools/variants.py``) and launched as ``fused_mlp_forward`` launches
the package's (``launch`` below); every variant is timed at the MXU PPO
trainer's 1024 and 16,384 rows (``learner_cases.fused_mlp_case``) by its
device time (CUDA events behind a spin kernel, ``learner_cases.fenced_ms``),
in rotating order. Variants that drop work give wrong outputs on purpose:
their time says what that work costs, and their largest error against the
plain version is printed beside it. A substitution that no longer matches
the source raises before anything is built. Prints one JSON object (also
written to ``--out``) with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from pathlib import Path

import torch

from ..ops import _build
from ..ops import fused_mlp as fm
from . import learner_cases as lc
from . import variants as var

SRC = "fused_mlp.cu"
_MMA3 = '''        if (lo) mma(acc[mt][nt], alo[mt], bhi[nt]);
        mma(acc[mt][nt], ahi[mt], blo[nt]);
'''
_SPLIT = '''  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(h))) & 0xffffe000u;'''
_TANH = '''          y.x = tanhf(y.x);
          y.y = tanhf(y.y);'''
_UNROLL = '''  const float* b = B + t * ldb + g;
#pragma unroll
'''
# name -> (what it changes, [(old, new), ...]); the first is the kernel as built.
VARIANTS = {
    "as built": ("3xTF32, the source unchanged", []),
    "one product": ("hi·hi alone (1xTF32): two of the three mma.sync a product dropped",
                    [(_MMA3, "")]),
    "no split": ("the raw fp32 bits as hi and lo: the split's integer and float ops dropped",
                 [(_SPLIT, "  hi = __float_as_uint(x);\n  lo = hi;")]),
    "no tanh": ("the epilogue's tanhf dropped", [(_TANH, "")]),
    "no zero-lo skip": ("layer 1 always issues lo_x·hi_w1 (no warp vote)",
                        [("mma_tile<G::MT, G::NT, KT / 8, true>",
                          "mma_tile<G::MT, G::NT, KT / 8, false>")]),
    "unroll 2": ("the k-steps of a product unrolled by 2, not fully",
                 [(_UNROLL, _UNROLL.replace("#pragma unroll\n", "#pragma unroll 2\n"))]),
    "no layer-1 products": ("layer 1's products and fragment loads dropped (copies and "
                            "barriers kept)",
                            [("      mma_tile<G::MT, G::NT, KT / 8, true>(",
                              "      if (false) mma_tile<G::MT, G::NT, KT / 8, true>(")]),
    "no layer-2/3 products": ("layers 2 and 3's products and fragment loads dropped",
                              [("    mma_tile<G::MT, G::NT, kH / 8, false>(acc, hs",
                                "    if (false) mma_tile<G::MT, G::NT, kH / 8, false>(acc, hs")]),
    "no output stores": ("h1, h2 and out not written to device memory",
                         [("        if (r < rows) *reinterpret_cast<float2*>(gout",
                           "        if (false) *reinterpret_cast<float2*>(gout")]),
    "no layer-1 copies": ("no x or w1 k-tile copied (layer 1 runs on what the ring holds)",
                          [("      if (kt < nkt) issue(tile, kt);", ""),
                           ("      if (kt + S - 1 < nkt) issue(tile, kt + S - 1);", "")]),
    "32-row tiles": ("32-row tiles at every B (512 tiles at 16,384 rows)",
                     [("  if (2 * ((B + 63) / 64) > n_sm) return 64;\n", "")]),
}


def variant_sources(out_dir: Path) -> dict:
    """``name -> .cu path`` of every variant, written under ``out_dir``."""
    paths = var.write_variants([SRC], {name: [(SRC, old, new) for old, new in changes]
                                       for name, (_, changes) in VARIANTS.items()}, out_dir)
    return {name: p[SRC] for name, p in paths.items()}


def build_variants(out_dir: Path) -> dict:
    """``name -> bound fused_mlp_launch`` of every variant."""
    built = var.build(variant_sources(out_dir / "src"), out_dir)
    return {name: fm.bind(ctypes.CDLL(str(b.so))) for name, b in built.items()}


def launch(fn, x, w1, b1, w2, b2, wh, bh) -> tuple:
    """``(out, h1, h2)`` from the bound ``fused_mlp_launch`` ``fn``, with the
    one ``[3, B, 128]`` buffer and the stream of ``fused_mlp_forward``."""
    B, D = x.shape
    buf = torch.empty((3, B, fm.HIDDEN), dtype=torch.float32, device=x.device)
    _build.check(fn(x.data_ptr(), B, D, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), wh.data_ptr(), bh.data_ptr(), buf.data_ptr(),
                    _build.stream_of(x.device)), "fused_mlp_launch")
    return buf.unbind(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("b11_variants: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    result = {"card": lc.nvidia_smi("name,power.limit"), "variants": {}}
    print(f"card {result['card']}", flush=True)
    fns = build_variants(Path(_build.BUILD_DIR) / "variants")
    g = torch.Generator(device=dev).manual_seed(0)
    for B in lc.B11_CASES.values():
        x = lc.fused_mlp_case(B, dev, g)
        ref = fm.fused_mlp_reference(*x)
        times = {name: [] for name in fns}
        errs = {}
        for name, fn in fns.items():
            out = launch(fn, *x)
            torch.cuda.synchronize()
            errs[name] = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        order = list(fns)
        for r in range(args.rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                times[name].append(lc.fenced_ms(lambda fn=fns[name]: launch(fn, *x)))
        for name in fns:
            row = {"change": VARIANTS[name][0], "device_ms": statistics.median(times[name]),
                   "runs_ms": times[name], "max_abs_err": errs[name]}
            result["variants"].setdefault(name, {})[B] = row
            print(f"B={B:5d} {name:16s} device {row['device_ms']:.4f} ms; max |err| vs plain "
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
