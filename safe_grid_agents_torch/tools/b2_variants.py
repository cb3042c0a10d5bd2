"""What B2's step costs (``csrc/tabular_kernel.cu``): the kernel as built,
with B8's grouping of hot cells put back, and with all but the chain of a
step taken away, on one card.

    python -m safe_grid_agents_torch.tools.b2_variants [--rounds 4] [--out b2.json]

Each variant is the kernel's source with textual changes (``VARIANTS``),
built with the package's nvcc flags into ``_build/variants_b2/`` (one nvcc
each, all started together, ``tools/variants.py``) and launched through the
package's wrapper (``tabq``: its checks, its carved buffer and its call)
with the variant's entry point. Every variant is timed by its device time
(CUDA events behind a spin kernel, ``learner_cases.fenced_ms``), in
alternating order, at the shift preset's N = 64, T = 128 and at N = 4096,
T = 8192, each from a reset and from the hot-cell start (every lane on the
reset state late in the ε anneal). The kernel as built adds each lane's TD
error and count with native integer atomics; the grouped variant first
groups a warp's lanes by cell with ``__match_any_sync`` and has one leader a
group add the group's sum and count: its outputs stay bitwise equal to the
plain version's, the sums being exact in any order. The chain variants keep
only what a lane's next state waits on, for the first lane slot of each
thread: the Q row, the greedy action, the ε-greedy choice from the staged
draws, the packed table entry and the time limit (no TD error, atomics,
update, episode sums or other lane slots), once with the step's two block
barriers, once without; their outputs are wrong on purpose, and their time
is a floor of a step of this design. A substitution that no longer matches
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
from ..ops import tabular_kernel as tk
from . import learner_cases as lc
from . import variants as var

SRC = "tabular_kernel.cu"
_PER_LANE = """#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int k = cell[j];
      if (k < 0) continue;
      const unsigned before = atomicAdd(&s_cnt[k], 1u);
      if (kSmem)
        add_fixed(&s_td[k], (unsigned long long)td_fx[j]);
      else
        atomicAdd(&s_td[k], (unsigned long long)td_fx[j]);  // native in device memory
      if (before != 0u) cell[j] = -1;
    }
"""
# B8's grouping: a warp's lanes on one cell post their TD errors to slots,
# one leader a group sums them and adds the sum and the group's count.
_GROUPED = """#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      __shared__ unsigned long long grouped_slots[kMaxThreads];
      const int me = threadIdx.x & 31;
      unsigned long long* slots = grouped_slots + (threadIdx.x & ~31);
      const int lane = threadIdx.x + j * blockDim.x;
      const unsigned live = __ballot_sync(0xffffffffu, lane < N);
      const int k = cell[j];
      cell[j] = -1;
      if (lane >= N) continue;
      const unsigned peers = __match_any_sync(live, k);
      const unsigned others = peers & ~(1u << me);
      if (others != 0u) slots[me] = (unsigned long long)td_fx[j];
      __syncwarp(live);
      if (me == __ffs(peers) - 1) {
        const unsigned before = atomicAdd(&s_cnt[k], (unsigned)__popc(peers));
        unsigned long long sum = (unsigned long long)td_fx[j];
        for (unsigned rest = others; rest != 0u; rest &= rest - 1u) sum += slots[__ffs(rest) - 1];
        add_fixed(&s_td[k], sum);
        if (before == 0u) cell[j] = k;
      }
      __syncwarp(live);
    }
"""
# The grouped variant's slots are static shared memory, so its launch opts
# in to the dynamic size at every shape.
_OPT_IN = ("  if (L.total > 48 * 1024) {", "  if (true) {")
# The chain: the first lane slot alone, and of its step only what the next
# state waits on.
_SLOTS = ("""    for (int j = 0; j < kLanes; ++j) {
      const int lane = threadIdx.x + j * blockDim.x;
      cell[j] = -1;""", """    for (int j = 0; j < 1; ++j) {
      const int lane = threadIdx.x + j * blockDim.x;
      cell[j] = -1;""")
_AFTER_ENTRY = """      const float r = __uint_as_float(e.y);
      const int t1 = t[j] + 1;
      const bool done = e.w != 0u || t1 >= max_steps;
      const float boot = max_of(s_q + nxt * A, A);
      const float target = __fadd_rn(r, __fmul_rn(gamma, done ? 0.f : boot));
      cell[j] = k;
      td_fx[j] = __float2ll_rn(__fmul_rn(__fsub_rn(target, qrow[act]), kTdScale));

      const float dx = done ? 1.f : 0.f;
      epr[j] = __fadd_rn(epr[j], r);
      eph[j] = __fadd_rn(eph[j], __uint_as_float(e.z));
      epl[j] += 1;
      eacc[j] = __fadd_rn(eacc[j], dx);
      racc[j] = __fadd_rn(racc[j], __fmul_rn(dx, epr[j]));
      hacc[j] = __fadd_rn(hacc[j], __fmul_rn(dx, eph[j]));
      lacc[j] = __fadd_rn(lacc[j], __fmul_rn(dx, (float)epl[j]));
      idx[j] = t1 >= max_steps ? reset_idx : nxt;
      t[j] = done ? 0 : t1;
      epr[j] = done ? 0.f : epr[j];
      eph[j] = done ? 0.f : eph[j];
      epl[j] = done ? 0 : epl[j];
"""
_CHAIN_ENTRY = """      const int t1 = t[j] + 1;
      const bool done = e.w != 0u || t1 >= max_steps;
      idx[j] = t1 >= max_steps ? reset_idx : nxt;
      t[j] = done ? 0 : t1;
"""
_UPDATE = """#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int c = cell[j];
      if (c < 0) continue;
      if (kSmem) {
        const double sum = __dmul_rn(__ll2double_rn((long long)s_td[c]), kTdUnit);
        const float upd =
            __fdiv_rn(__fmul_rn(lr, __double2float_rn(sum)), fmaxf((float)s_cnt[c], 1.f));
        s_q[c] = __fadd_rn(s_q[c], upd);
      } else {  // the same update from the atomics' results, read from L2
        const double sum = __dmul_rn(__ll2double_rn((long long)__ldcg(s_td + c)), kTdUnit);
        const float upd = __fdiv_rn(__fmul_rn(lr, __double2float_rn(sum)),
                                    fmaxf((float)__ldcg(s_cnt + c), 1.f));
        s_q[c] = __fadd_rn(s_q[c], upd);
      }
      s_td[c] = 0ull;
      s_cnt[c] = 0u;
    }
"""
_CHAIN = [_SLOTS, (_AFTER_ENTRY, _CHAIN_ENTRY), (_PER_LANE, ""), (_UPDATE, "")]
_BARRIERS = [("    SGA_STAMP(2);\n    __syncthreads();\n", "    SGA_STAMP(2);\n"),
             ("    __syncthreads();  // the update (and the next tile) visible to every lane\n",
              "")]
# name -> (what it changes, [(old, new), ...]); the first is the kernel as built.
VARIANTS = {
    "as built": ("one set of atomics a lane", []),
    "grouped": ("a warp's lanes grouped by cell with __match_any_sync, one leader a group "
                "adding the group's sum and count", [(_PER_LANE, _GROUPED), _OPT_IN]),
    "chain only": ("the first lane slot's Q row, greedy action, draw, table entry and time "
                   "limit alone, with the step's two barriers (outputs wrong on purpose)",
                   _CHAIN),
    "chain only, no barriers": ("the same without the step's two barriers (the draw tiles "
                                "race: outputs wrong on purpose)", _CHAIN + _BARRIERS),
}
# (case name, lc.B2_CASES key, hot start)
CASES = (("cli", "shift cli", False), ("cli hot", "shift cli", True),
         ("wide", "shift wide", False), ("wide hot", "shift wide", True))


def variant_sources(out_dir: Path) -> dict:
    """``name -> .cu path`` of every variant, written under ``out_dir``."""
    paths = var.write_variants(
        [SRC], {name: [(SRC, old, new) for old, new in changes]
                for name, (_, changes) in VARIANTS.items()}, out_dir)
    return {name: p[SRC] for name, p in paths.items()}


def build_variants(out_dir: Path) -> dict:
    """``name -> bound tabq_launch`` of every variant."""
    built = var.build(variant_sources(out_dir / "src"), out_dir)
    return {name: tk.bind(ctypes.CDLL(str(b.so))) for name, b in built.items()}


def launch(fn, args):
    """``tk.tabq(*args)`` with the variant's entry point."""
    with var.swapped(tk, _fn=fn):
        return tk.tabq(*args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("b2_variants: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    result = {"card": lc.nvidia_smi("name,power.limit"), "variants": {}}
    print(f"card {result['card']}", flush=True)
    fns = build_variants(Path(_build.BUILD_DIR) / "variants_b2")
    g = torch.Generator(device=dev).manual_seed(0)
    for label, name, hot in CASES:
        call = lc.tabq_case(name, dev, g, hot=hot)
        ref = tk.tabq_reference(*call)
        equal = {}
        for vname, fn in fns.items():
            out = launch(fn, call)
            torch.cuda.synchronize()
            equal[vname] = lc.outputs_equal(out, ref)
        times = {vname: [] for vname in fns}
        order = list(fns)
        for r in range(args.rounds):
            for vname in order if r % 2 == 0 else order[::-1]:
                times[vname].append(lc.fenced_ms(lambda fn=fns[vname]: launch(fn, call), reps=3))
        T, N = call[5].shape
        for vname in fns:
            row = {"change": VARIANTS[vname][0], "device_ms": statistics.median(times[vname]),
                   "runs_ms": times[vname], "cycles_per_step_at_1980MHz":
                   statistics.median(times[vname]) * 1.98e6 / T,
                   "outputs_equal_plain": equal[vname]}
            result["variants"].setdefault(vname, {})[label] = row
            print(f"B2 {label:8s} N={N:4d} T={T:4d} {vname:27s} device {row['device_ms']:.4f} ms "
                  f"({row['cycles_per_step_at_1980MHz']:.0f} cycles a step); outputs "
                  f"{'equal to' if equal[vname] else 'differ from'} the plain version's",
                  flush=True)
    result["clocks_after"] = lc.nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
