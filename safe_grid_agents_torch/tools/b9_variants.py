"""What B9's step costs (``csrc/dqn_stoch_kernel.cu``): the kernel as built,
with other choices of its design, and with all but the chain of a step
taken away, on one card.

    python -m safe_grid_agents_torch.tools.b9_variants [--rounds 12] [--out b9.json]

Each variant is the kernel's source with textual changes (``VARIANTS``),
built with the package's nvcc flags into ``_build/variants_b9/`` (one nvcc
each, all started together, ``tools/variants.py``) and launched through the
package's wrapper (``dqn_stoch_collect``: its checks, its carved buffer and
its call) with the variant's entry point. Every variant is timed by its
device time (CUDA events behind a spin kernel, ``learner_cases.fenced_ms``),
in alternating order, at ``learner_cases.B9_CASES``: the whisky command's
N = 128, T = 32 and N = 4096, T = 4096 on absent, whisky, tomato and friend
at cap 127, and each variant's count of rounds in which it was faster than
the kernel as built. The variants that keep the kernel's function must stay
bitwise equal to the plain version: 16-step tiles; ε once a step and lane;
the records through the record tile at every placement (as built only with
the tables in device memory), stored as built, in batches with
evict-first stores, or by the bulk-copy engine; the records stored from
registers at every placement (as built only with the tables in shared
memory); the greedy row in shared memory at every placement (as built only
beside the tables there), alone and with the records from registers. The
others drop work on purpose: the records, or everything but
what a lane's next state waits on (the chain: the greedy read, the
ε-greedy choice, drying, whisky's drunk read, the table entry, the time
limit and the reset), once with the draws streamed tile by tile and once
with the first tile's draws walked again (no streaming). The chain without
streaming is the floor of a step of this design. A substitution that no
longer matches the source raises before anything is built. Cycles a step
are counted at 1.98 GHz, the card's SM clock under this load in earlier
runs (the SM clock after the runs is printed too). Prints one JSON object
(also written to ``--out``) with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from pathlib import Path

import torch

from ..ops import _build
from ..ops import dqn_stoch_kernel as dsk
from . import learner_cases as lc
from . import variants as var

SRC = "dqn_stoch_kernel.cu"
_TILES = ("constexpr int kMaxTile = 128, kMinTile = 16;",
          "constexpr int kMaxTile = 16, kMinTile = 16;")
_EPS = ("        const int act = uu < s_eps[k] ? ra : greedy[pidx];  // the CHOSEN action\n",
        """        const int64_t step_t = st0 + (int64_t)(s0 + k) * N;
        float frac = __fdiv_rn(__ll2float_rn(step_t), anneal);
        frac = fminf(fmaxf(frac, 0.f), 1.f);
        const float eps_t = __fadd_rn(eps0, __fmul_rn(frac, eps_delta));
        const int act = uu < eps_t ? ra : greedy[pidx];
""")
_RECORDS = """        // The records in the buffer's order: the int32 ones, then reward.
        const uint32_t v[kRecords] = {(uint32_t)pidx, (uint32_t)pt, (uint32_t)act,
                                      (uint32_t)o.nxt, o.done ? 1u : 0u,
                                      __float_as_uint(use_hidden ? o.hidden : o.reward)};
        if (kRecordTile) {
          uint32_t* r = s_rec + k * kThreads + threadIdx.x;
#pragma unroll
          for (int j = 0; j < kRecords; ++j) r[j * slot] = v[j];
        } else {  // a warp's 32 words are one coalesced 128-byte row
          uint32_t* r = rec + (size_t)(s0 + k) * N + lane;
#pragma unroll
          for (int j = 0; j < kRecords; ++j) r[j * TN] = v[j];
        }
"""
_STORE = ("    if (kRecordTile) store_records(rec, s_rec, slot, s0, steps, T, N, lane0, n_live, "
          "vec16);\n")


def _record_tile(on: bool):
    """The record tile at every placement (``on``) or at none."""
    return [("  constexpr bool kRecordTile = kPlace == kGlobal;  // Layout",
             f"  constexpr bool kRecordTile = {str(on).lower()};  // Layout"),
            ("  const bool record_tile = place == kGlobal;",
             f"  const bool record_tile = {str(on).lower()};")]


# The int32 greedy row staged in shared memory at every placement: beside
# the tables in device memory too (friend at cap 127).
_GREEDY_SHARED = [("""    L.greedy = at;
    at += r16(4 * (size_t)S);
  }
  L.total = at;""", """  }
  L.greedy = at;
  at += r16(4 * (size_t)S);
  L.total = at;"""), ("    env = stage_env(genv, S, L, smem);\n",
                     "    env = stage_env(genv, S, L, smem);\n  }\n  {\n")]


# The record tile's stores in batches of 8 rows a thread, every load of a
# batch issued before its stores, the stores marked evict-first.
_BATCHED = ("""          *reinterpret_cast<uint4*>(rec + (r * (size_t)T + s0 + row) * N + lane0 + q) =
              *reinterpret_cast<const uint4*>(s_rec + r * slot + row * kThreads + q);
""", """          if ((row - (int)threadIdx.x / (kThreads / 4)) % 32 == 0) {
            uint4 v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (row + 4 * j < steps)
                v[j] = *reinterpret_cast<const uint4*>(s_rec + r * slot + (row + 4 * j) * kThreads + q);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (row + 4 * j < steps)
                __stcs(reinterpret_cast<uint4*>(rec + (r * (size_t)T + s0 + row + 4 * j) * N +
                                                lane0 + q), v[j]);
          }
""")
# The record tile copied to device memory by the bulk-copy engine (TMA), one
# copy a record row, the copies' reads of shared memory waited on before
# the tile is written again.
_TMA_FN = ("template <int kPlace>\n__global__", """__device__ __forceinline__ void bulk_records(uint32_t* rec, const uint32_t* s_rec, int slot,
                                             int s0, int steps, int T, int N, int lane0,
                                             int n_live) {
  for (int r = 0; r < kRecords; ++r)
    for (int row = threadIdx.x; row < steps; row += kThreads) {
      const unsigned src = (unsigned)__cvta_generic_to_shared(s_rec + r * slot + row * kThreads);
      uint32_t* dst = rec + (r * (size_t)T + s0 + row) * N + lane0;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n" ::"l"(dst),
                   "r"(src), "r"(4 * n_live)
                   : "memory");
    }
  asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
}

template <int kPlace>
__global__""")
_TMA = [_TMA_FN,
        ("    __syncthreads();  // the record tile is complete, the ε tile read\n",
         "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
         "    __syncthreads();  // the record tile is complete, the ε tile read\n"),
        (_STORE, "    if (vec16) {\n"
                 "      bulk_records(rec, s_rec, slot, s0, steps, T, N, lane0, n_live);\n"
                 "    } else {\n  " + _STORE + "    }\n"),
        ("    stage::wait_all();  // this thread's copies of the next tile\n",
         "    asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: \"memory\");\n"
         "    stage::wait_all();  // this thread's copies of the next tile\n")]
_SUMS = """        const float dx = o.done ? 1.f : 0.f;
        eacc = __fadd_rn(eacc, dx);
        racc = __fadd_rn(racc, __fmul_rn(dx, o.epr));
        hacc = __fadd_rn(hacc, __fmul_rn(dx, o.eph));
        lacc = __fadd_rn(lacc, __fmul_rn(dx, (float)o.epl));
"""
_STEP = ("""        const LaneStep o = kPlace == kShared ? stoch_lane_step(env, st, act, b, sm, r2)
                                             : global_lane_step(env, st, act, b, sm, r2);
""", "        chain_step(env, st, act, b, sm, r2);\n")
# The step's chain: what the next index and time wait on, every table load
# issued before the selects (global_lane_step's order).
_CHAIN_STEP = ("template <int kPlace>\n__global__", """__device__ __forceinline__ void chain_step(const StochEnv& env, LaneState& lane,
                                           int action, int bits, int stumble, int rand_a) {
  int e = lane.idx;
  if (env.dry_mask) e -= e & env.dry_mask & bits;
  int a = action;
  if (env.drunk != nullptr && env.drunk[e] != 0 && stumble > 0) a = rand_a;
  const int k = e * env.A + a;
  const int nxt = env.next[k];
  const bool env_done = env.done[k] != 0;
  int c0 = 0, c1 = 0;
  if (env.mode == 2) {
    c0 = env.cand0[k];
    c1 = env.cand1[k];
  }
  const int t1 = lane.t + 1;
  const bool done = env_done || t1 >= env.max_steps;
  int reset = env.r0;
  if (env.mode == 1) {
    reset = bits > 0 ? env.r1 : env.r0;
  } else if (env.mode == 2) {
    reset = bits > 0 ? c1 : c0;
  }
  lane.idx = done ? reset : nxt;
  lane.t = done ? 0 : t1;
}

template <int kPlace>
__global__""")
_NO_RECORDS = [(_RECORDS, ""), (_STORE, "")]
_CHAIN = [_CHAIN_STEP, _STEP, *_NO_RECORDS, (_SUMS, "")]
_NO_STREAMING = [("""    if (s0 + tile < T)  // the next tile, into the other buffer
      stage_tile(s_in + (cur ^ 1) * buf_words, streams, tile, s0 + tile,
                 min(tile, T - s0 - tile), lane0, n_live, N, vec16);
""", ""), ("    cur ^= 1;\n", "")]
# name -> (what it changes, [(old, new), ...]); the first is the kernel as built.
VARIANTS = {
    "as built": ("the kernel as built", []),
    "16-step tiles": ("tiles of 16 steps at every shape", [_TILES]),
    "eps a step": ("ε computed by each lane at each step, not once a tile", [_EPS]),
    "record tile": ("the records through the record tile at every placement",
                    _record_tile(True)),
    "record tile, batched": ("the record tile at every placement, stored in batches of 8 "
                             "rows a thread (loads before stores), evict-first",
                             _record_tile(True) + [_BATCHED]),
    "record tile, bulk copies": ("the record tile at every placement, copied to device "
                                 "memory by the bulk-copy engine (TMA), a copy a row",
                                 _record_tile(True) + _TMA),
    "records from registers": ("the records stored by each lane at each step at every "
                               "placement, no record tile", _record_tile(False)),
    "greedy row in shared memory": ("the greedy row staged in shared memory beside the "
                                    "tables in device memory too", _GREEDY_SHARED),
    "records from registers, greedy row in shared memory": (
        "both of these at every placement", _record_tile(False) + _GREEDY_SHARED),
    "no records": ("no records written (outputs wrong on purpose)", _NO_RECORDS),
    "chain only": ("the chain of a step alone, the draws streamed (outputs wrong on "
                   "purpose)", _CHAIN),
    "chain only, no streaming": ("the chain alone on the first tile's draws walked again "
                                 "(outputs wrong on purpose): the floor", _CHAIN + _NO_STREAMING),
}


def variant_sources(out_dir: Path) -> dict:
    """``name -> .cu path`` of every variant, written under ``out_dir``."""
    paths = var.write_variants(
        [SRC], {name: [(SRC, old, new) for old, new in changes]
                for name, (_, changes) in VARIANTS.items()}, out_dir)
    return {name: p[SRC] for name, p in paths.items()}


def build_variants(out_dir: Path) -> dict:
    """``name -> bound dqn_stoch_collect_launch`` of every variant."""
    built = var.build(variant_sources(out_dir / "src"), out_dir)
    return {name: dsk.bind(ctypes.CDLL(str(b.so))) for name, b in built.items()}


def launch(fn, args):
    """``dsk.dqn_stoch_collect(*args)`` with the variant's entry point."""
    with var.swapped(dsk, _fn=fn):
        return dsk.dqn_stoch_collect(*args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=12)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("b9_variants: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    result = {"card": lc.nvidia_smi("name,power.limit"), "variants": {}}
    print(f"card {result['card']}", flush=True)
    fns = build_variants(Path(_build.BUILD_DIR) / "variants_b9")
    g = torch.Generator(device=dev).manual_seed(0)
    for name in lc.B9_CASES:
        call = lc.dqn_stoch_collect_case(name, dev, g)
        ref = dsk.dqn_stoch_collect_reference(*call)
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
            ms = statistics.median(times[vname])
            row = {"change": VARIANTS[vname][0], "device_ms": ms, "runs_ms": times[vname],
                   "rounds_faster_than_as_built": sum(
                       a < b for a, b in zip(times[vname], times["as built"])),
                   "cycles_per_step_at_1980MHz": ms * 1.98e6 / T,
                   "outputs_equal_plain": equal[vname]}
            result["variants"].setdefault(vname, {})[name] = row
            print(f"B9 {name:15s} N={N:4d} T={T:4d} {vname:24s} device {ms:.4f} ms "
                  f"({row['cycles_per_step_at_1980MHz']:.0f} cycles a step, faster than as "
                  f"built in {row['rounds_faster_than_as_built']} of {args.rounds} rounds); "
                  f"outputs "
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
