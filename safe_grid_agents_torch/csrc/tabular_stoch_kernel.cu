// Fused tabular-Q training on a stochastic compiled env: ε-greedy act ->
// env step with the stochastic mechanics -> duplicate-averaged TD over all
// N lanes, for T steps, in one thread block.
//
// Replaces safe_grid_agents_tpu/ops/tabular_stoch_kernel.py::_kernel
// (launched by tabq_stoch_run through pl.pallas_call): Q, the TD sums and
// counts in shared memory, each thread owning up to 4 lanes, with B7's
// per-lane step from stoch_step.cuh. Two distinctions are kept exact:
//   * the CHOSEN action (ε-greedy, ties of the argmax to the lowest action)
//     is what the agent learns; the EFFECTIVE one (whisky's stumble) steps
//     the env;
//   * the agent acts and takes its TD at the index it observed (pre-dry);
//     the env steps the DRIED index (tomato).
// The TD target bootstraps from the pre-update Q at the successor.
//
// Where the env tables live is a template parameter: shared memory beside
// Q when both fit in one block's 227 KB (tomato: 86 KB of Q, sums and
// counts plus 70 KB of tables), device memory otherwise (friend at cap 15:
// the tables would take 182 KB more).
//
// The Hopper design. Every step's TD sums over all N lanes must land before
// any lane reads Q again, so the batch lives in ONE block with two barriers
// per step (after the TD sums, after the update). Around that chain:
//   * Only the touched cells are updated. At most N of the S·A cells change
//     in a step; the first design swept all S·A cells after every step (5400
//     on tomato: ~84 passes of its 64 threads at the CLI's N = 64). Here the
//     count's shared-memory atomic returns 0 to exactly one adder of each
//     touched cell, which owns the cell: after the barrier the owners alone
//     apply Q += lr·Σtd / max(cnt, 1) and clear the cell's sum and count.
//     An untouched cell keeps its value where the dense sweep added +0.0;
//     the two differ only for a Q entry of -0.0, which never arises: Q
//     starts at +0.0 (or at values drawn away from zero), and a
//     round-to-nearest add returns -0.0 only for (-0.0) + (-0.0), while
//     every update lr·sum/cnt of a touched cell is +0.0 or nonzero.
//   * Lanes of a warp that hit the same (s, a) are grouped with
//     __match_any_sync; the group's leader sums its members' fixed-point TD
//     errors, posted to per-warp shared slots (integer adds: exact in any
//     order), and adds the sum and the group's count. After a reset thousands of lanes stand on one
//     state, so a hot cell takes one atomic per warp instead of one per lane.
//   * The [T, N] draw streams do not depend on the state: they are staged
//     into shared memory with cp.async in tiles of up to TB_TS = 32 steps,
//     double-buffered, the next tile issued at the start of the current one
//     and awaited before the last barrier of its last step, so the per-step
//     chain reads only shared memory. The tile depth is the largest that
//     fits beside Q and the tables (32 at the CLI's N = 64; 1-2 at N = 4096
//     where the tables leave room; none on tomato at N = 4096, which then
//     reads the streams from device memory).
// SGA_STAMP markers (compiled only with -DSGA_TRACE: thread 0 records
// clock64() at each, no extra barriers) split a step into act + env step,
// TD aggregation + atomics, the barrier after them, the update of the
// touched cells, and the barrier after it (tools/trace_learners.py).
//
// Numerics: round-to-nearest intrinsics everywhere, so no FMA moves a
// `u < ε` decision. The TD sums are not float atomics: on these envs lanes
// in one (s, a) cell see different successors (stumble, drying, timeouts),
// so a run-dependent order of float adds changes Q in the last bit, and
// over a few hundred steps an argmax near a tie flips and the trajectories
// part (measured on the card at N = 4096, T = 256 on tomato). Each TD error
// is a 64-bit fixed-point integer (2^-32 units, rounded to nearest even);
// integer adds are exact in any order, so the kernel is deterministic and
// bitwise equal to the plain version, which sums the same integers. The
// sum returns to float through double, as the plain version converts it.
// Range: |TD| < 2^19 per lane at N <= 4096 (int64 holds 2^63); this
// suite's TD errors stay below ~10^4. The sums are added in two 32-bit
// words with an explicit carry (add_fixed), which is the same integer sum.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stoch_step.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLanesPerThread = 4;   // N <= 4096
constexpr int kMaxTile = 32;         // TB_TS: the reference's T-block
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap
constexpr float kTdScale = 4294967296.f;       // 2^32: TD fixed-point units
constexpr double kTdUnit = 1.0 / 4294967296.0;  // 2^-32
constexpr unsigned kFull = 0xffffffffu;

#ifdef SGA_TRACE
constexpr int kStampSteps = 8192, kStampN = 8;
__device__ long long g_stamps[kStampSteps * kStampN];
#define SGA_STAMP(i)                                     \
  do {                                                   \
    if (threadIdx.x == 0 && s < kStampSteps)             \
      g_stamps[s * kStampN + (i)] = clock64();           \
  } while (0)
#else
#define SGA_STAMP(i) \
  do {               \
  } while (0)
#endif

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Adds the fixed-point value `v` to the 64-bit sum at `cell` exactly, as two
// native 32-bit shared-memory atomics: the low word's add returns its old
// value, whose wrap gives the carry into the high word. (A 64-bit atomicAdd
// on shared memory compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.64,
// which retries under contention.) Sums are taken mod 2^64 either way.
__device__ __forceinline__ void add_fixed(unsigned long long* cell, unsigned long long v) {
  unsigned* word = reinterpret_cast<unsigned*>(cell);  // little-endian: low word first
  const unsigned lo = (unsigned)v, hi = (unsigned)(v >> 32);
  const unsigned old = atomicAdd(word, lo);
  atomicAdd(word + 1, hi + (old + lo < old ? 1u : 0u));
}

// The streams the env reads: rand_a and u always, bits (coin or drying)
// and stumble, rand2 (noise) where the env uses them, else null. A tile
// holds the used ones in this order, n of them.
struct Streams {
  const uint32_t *rand_a, *u, *bits, *stumble, *rand2;
  int n;
};

// Issues the copies of `n` words from `g` to `d`.
__device__ __forceinline__ void stage_stream(uint32_t* d, const uint32_t* g, int n,
                                             bool vec16) {
  if (vec16) {
    for (int c = 4 * threadIdx.x; c < n; c += 4 * blockDim.x) cp_async16(d + c, g + c);
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x) cp_async4(d + c, g + c);
  }
}

// Issues the copies of steps [s0, s0 + steps) of every used stream into
// `dst` (the i-th used stream at dst + i·TS·N) and commits them as one
// group.
__device__ __forceinline__ void stage_tile(uint32_t* dst, const Streams& st, int s0,
                                           int steps, int N, int TS, bool vec16) {
  const int n = steps * N;
  const size_t tile = (size_t)TS * N, at = (size_t)s0 * N;
  stage_stream(dst, st.rand_a + at, n, vec16);
  stage_stream(dst + tile, st.u + at, n, vec16);
  if (st.bits != nullptr) stage_stream(dst + 2 * tile, st.bits + at, n, vec16);
  if (st.stumble != nullptr) {
    const size_t i = st.bits != nullptr ? 3 : 2;
    stage_stream(dst + i * tile, st.stumble + at, n, vec16);
    stage_stream(dst + (i + 1) * tile, st.rand2 + at, n, vec16);
  }
  cp_async_commit();
}

template <bool kSmemTables, bool kStage>
__global__ void __launch_bounds__(kMaxThreads) tabq_stoch_kernel(
    StochEnv genv, int S, float lr, float gamma, float eps0, float eps_delta,
    float anneal, const float* __restrict__ q0, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0,
    const int64_t* __restrict__ step0, Streams streams, int TS, int vec16, size_t tile_at,
    int T, int N, float* __restrict__ q_o, int32_t* __restrict__ idx_o,
    int32_t* __restrict__ t_o, float* __restrict__ epr_o, float* __restrict__ eph_o,
    int32_t* __restrict__ epl_o, int64_t* __restrict__ step_o,
    float* __restrict__ eacc_o, float* __restrict__ racc_o,
    float* __restrict__ hacc_o, float* __restrict__ lacc_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = genv.A;
  const int SA = S * A;
  unsigned long long* s_td = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* s_agg = s_td + SA;  // a slot per thread: the warps' group sums
  float* s_q = reinterpret_cast<float*>(s_agg + kMaxThreads);
  unsigned* s_cnt = reinterpret_cast<unsigned*>(s_q + SA);
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem + tile_at);  // [2][streams][TS][N]
  StochEnv env = genv;
  if (kSmemTables) env = stage_tables(genv, S, reinterpret_cast<unsigned char*>(s_cnt + SA));
  if (kStage) stage_tile(tiles, streams, 0, min(TS, T), N, TS, vec16);
  for (int c = threadIdx.x; c < SA; c += blockDim.x) {
    s_q[c] = q0[c];
    s_td[c] = 0ull;
    s_cnt[c] = 0u;
  }
  const bool use_bits = env.mode != 0 || env.dry_mask != 0;
  const bool noise = env.drunk != nullptr;
  const int i_stumble = use_bits ? 3 : 2;  // the stumble stream's tile slot

  LaneState st[kLanesPerThread];
  float eacc[kLanesPerThread], racc[kLanesPerThread];
  float hacc[kLanesPerThread], lacc[kLanesPerThread];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const int lane = threadIdx.x + j * blockDim.x;
    const bool live = lane < N;
    st[j].idx = live ? idx0[lane] : 0;
    st[j].t = live ? t0[lane] : 0;
    st[j].epl = live ? epl0[lane] : 0;
    st[j].epr = live ? epr0[lane] : 0.f;
    st[j].eph = live ? eph0[lane] : 0.f;
    eacc[j] = racc[j] = hacc[j] = lacc[j] = 0.f;
  }
  const int64_t st0 = *step0;
  if (kStage) cp_async_wait_all();
  __syncthreads();

  int tile0 = 0, cur = 0;  // the current tile's first step and buffer
  for (int s = 0; s < T; ++s) {
    SGA_STAMP(0);
    if (kStage && s == tile0 && tile0 + TS < T)  // the next tile, into the other buffer
      stage_tile(tiles + (size_t)(cur ^ 1) * streams.n * TS * N, streams, tile0 + TS,
                 min(TS, T - tile0 - TS), N, TS, vec16);
    // This step's row of the staged tile (slot i at row + i·TS·N), or of the
    // streams in device memory.
    const size_t tsn = (size_t)TS * N;
    const uint32_t* row = tiles + (size_t)cur * streams.n * tsn + (size_t)(s - tile0) * N;
    const size_t at = (size_t)s * N;
    // Linear ε anneal from the global step counter (as B2).
    const int64_t step_t = st0 + (int64_t)s * N;
    float frac = __fdiv_rn(__ll2float_rn(step_t), anneal);
    frac = fminf(fmaxf(frac, 0.f), 1.f);
    const float eps_t = __fadd_rn(eps0, __fmul_rn(frac, eps_delta));

    // Phase 1a: act on the observed index, step, TD against the pre-update Q.
    int cell[kLanesPerThread];
    long long td_fx[kLanesPerThread];
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int lane = threadIdx.x + j * blockDim.x;
      cell[j] = -1;
      td_fx[j] = 0;
      if (lane >= N) continue;
      const int idx = st[j].idx;
      const float* qrow = s_q + idx * A;
      int greedy = 0;  // first max: ties go to the lowest action
      float m = qrow[0];
      for (int a = 1; a < A; ++a) {
        if (qrow[a] > m) { m = qrow[a]; greedy = a; }
      }
      const float uu = __uint_as_float(kStage ? row[tsn + lane] : streams.u[at + lane]);
      const int act = uu < eps_t ? (int)(kStage ? row[lane] : streams.rand_a[at + lane])
                                 : greedy;  // the CHOSEN action
      const int b = use_bits ? (int)(kStage ? row[2 * tsn + lane] : streams.bits[at + lane]) : 0;
      int sm = 0, r2 = 0;
      if (noise) {
        sm = (int)(kStage ? row[i_stumble * tsn + lane] : streams.stumble[at + lane]);
        r2 = (int)(kStage ? row[(i_stumble + 1) * tsn + lane] : streams.rand2[at + lane]);
      }
      const LaneStep o = stoch_lane_step(env, st[j], act, b, sm, r2);
      const float* nrow = s_q + o.nxt * A;
      float boot = nrow[0];
      for (int a = 1; a < A; ++a) boot = fmaxf(boot, nrow[a]);
      const float target = __fadd_rn(o.reward, __fmul_rn(gamma, o.done ? 0.f : boot));
      const float td = __fsub_rn(target, qrow[act]);
      cell[j] = idx * A + act;
      td_fx[j] = __float2ll_rn(__fmul_rn(td, kTdScale));

      const float dx = o.done ? 1.f : 0.f;
      eacc[j] = __fadd_rn(eacc[j], dx);
      racc[j] = __fadd_rn(racc[j], __fmul_rn(dx, o.epr));
      hacc[j] = __fadd_rn(hacc[j], __fmul_rn(dx, o.eph));
      lacc[j] = __fadd_rn(lacc[j], __fmul_rn(dx, (float)o.epl));
    }
    SGA_STAMP(1);
    // Phase 1b: per warp, group the lanes by cell; a leader per group adds
    // the group's exact TD sum and count. The members of a group of two or
    // more post their TD errors to the warp's slots, and the leader sums
    // them (integers: exact in any order). The leader whose count atomic
    // returns 0 owns the cell for phase 2. (A warp reduction with a mask
    // per group, __reduce_add_sync, writes a warp-uniform register, so the
    // compiler runs it once per distinct group: measured ~9,400 cycles a
    // step at N = 64, where most groups are single lanes.)
    const int me = threadIdx.x & 31;
    unsigned long long* slots = s_agg + (threadIdx.x & ~31);
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int lane = threadIdx.x + j * blockDim.x;
      const unsigned live = __ballot_sync(kFull, lane < N);
      const int k = cell[j];
      cell[j] = -1;
      if (lane >= N) continue;
      const unsigned peers = __match_any_sync(live, k);
      const unsigned others = peers & ~(1u << me);
      if (others != 0u) slots[me] = (unsigned long long)td_fx[j];
      __syncwarp(live);
      if (me == __ffs(peers) - 1) {
        unsigned long long sum = (unsigned long long)td_fx[j];
        for (unsigned rest = others; rest != 0u; rest &= rest - 1u) sum += slots[__ffs(rest) - 1];
        add_fixed(&s_td[k], sum);
        if (atomicAdd(&s_cnt[k], (unsigned)__popc(peers)) == 0u) cell[j] = k;
      }
      __syncwarp(live);  // the slots are read before the next lane slot's posts
    }
    SGA_STAMP(2);
    __syncthreads();
    SGA_STAMP(3);
    // Phase 2: each touched cell's owner applies Q += (lr · td_sum) / max(cnt, 1)
    // and clears the cell's sum and count.
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int c = cell[j];
      if (c < 0) continue;
      const double sum = __dmul_rn(__ll2double_rn((long long)s_td[c]), kTdUnit);
      const float upd =
          __fdiv_rn(__fmul_rn(lr, __double2float_rn(sum)), fmaxf((float)s_cnt[c], 1.f));
      s_q[c] = __fadd_rn(s_q[c], upd);
      s_td[c] = 0ull;
      s_cnt[c] = 0u;
    }
    SGA_STAMP(4);
    const bool tile_ends = s + 1 == tile0 + TS;
    if (kStage && tile_ends && s + 1 < T) cp_async_wait_all();  // this thread's next tile
    __syncthreads();  // the update (and the next tile) visible to every lane
    SGA_STAMP(5);
    if (kStage && tile_ends) {
      tile0 += TS;
      cur ^= 1;
    }
  }

  for (int c = threadIdx.x; c < SA; c += blockDim.x) q_o[c] = s_q[c];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const int lane = threadIdx.x + j * blockDim.x;
    if (lane >= N) continue;
    idx_o[lane] = st[j].idx;
    t_o[lane] = st[j].t;
    epr_o[lane] = st[j].epr;
    eph_o[lane] = st[j].eph;
    epl_o[lane] = st[j].epl;
    eacc_o[lane] = eacc[j];
    racc_o[lane] = racc[j];
    hacc_o[lane] = hacc[j];
    lacc_o[lane] = lacc[j];
  }
  if (threadIdx.x == 0) *step_o = st0 + (int64_t)T * N;
}

// Shared memory before the stream tiles: Q, its TD sums and counts (16
// bytes per (s, a)), the warps' aggregation slots (8 bytes a thread), plus
// the tables when they live there; rounded up to 16 bytes.
size_t base_bytes(int S, int A, int mode, bool noise, int smem_tables) {
  const size_t b = (size_t)S * A * 16 + (size_t)kMaxThreads * 8 +
                   (smem_tables ? stoch_table_bytes(S, A, mode, noise) : 0);
  return (b + 15) & ~(size_t)15;
}

// Steps per stream tile: the most, up to kMaxTile, whose two buffers fit
// beside the base (0: the streams are read from device memory).
int tile_steps(size_t base, int n_streams, int N, int T) {
  if (base > kMaxSmem) return 0;
  const size_t per_step = (size_t)2 * n_streams * N * 4;
  size_t ts = (kMaxSmem - base) / per_step;
  if (ts > (size_t)kMaxTile) ts = kMaxTile;
  if (ts > (size_t)T) ts = T;
  return (int)ts;
}

}  // namespace

#ifdef SGA_TRACE
// Copies the first n stamps ([step][marker], 8 a step) to `host`.
extern "C" int tabq_stoch_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * sizeof(long long));
}
#endif

// The steps per stream tile a launch with these shapes uses (0: the
// streams are read from device memory).
extern "C" int tabq_stoch_tile_steps(int S, int A, int mode, int dry_nbits, int noise,
                                     int smem_tables, int N, int T) {
  const int n_streams = 2 + (mode != 0 || dry_nbits != 0 ? 1 : 0) + (noise ? 2 : 0);
  return tile_steps(base_bytes(S, A, mode, noise != 0, smem_tables), n_streams, N, T);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). Needs
// 1 <= N <= 4096 and Q, its TD sums and counts (16 bytes per (s, a)) in
// shared memory; smem_tables puts the env tables there too. Actions drawn
// in rand_a/rand2 and all indices must be in range.
extern "C" int tabq_stoch_launch(
    const void* next, const void* reward, const void* hidden, const void* done,
    const void* cand0, const void* cand1, const void* drunk, int S, int A,
    int max_steps, int mode, int r0, int r1, int dry_nbits, int smem_tables,
    float lr, float gamma, float eps0, float eps_delta, float anneal,
    const void* q0, const void* idx0, const void* t0, const void* epr0,
    const void* eph0, const void* epl0, const void* step0, const void* rand_a,
    const void* u, const void* bits, const void* stumble, const void* rand2, int T,
    int N, void* q_o, void* idx_o, void* t_o, void* epr_o, void* eph_o, void* epl_o,
    void* step_o, void* eacc_o, void* racc_o, void* hacc_o, void* lacc_o,
    void* stream) {
  const bool noise = drunk != nullptr;
  const size_t base = base_bytes(S, A, mode, noise, smem_tables);
  if (base > kMaxSmem || N < 1 || N > kMaxThreads * kLanesPerThread || T < 0 ||
      mode < 0 || mode > 2 || dry_nbits < 0 || dry_nbits > 30 ||
      (mode == 2 && (cand0 == nullptr || cand1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StochEnv env{(const int32_t*)next, (const float*)reward, (const float*)hidden,
                     (const uint8_t*)done, (const int32_t*)cand0, (const int32_t*)cand1,
                     (const uint8_t*)drunk, A, max_steps, mode, r0, r1,
                     (1 << dry_nbits) - 1};
  const bool use_bits = mode != 0 || dry_nbits != 0;
  const Streams st{(const uint32_t*)rand_a, (const uint32_t*)u,
                   use_bits ? (const uint32_t*)bits : nullptr,
                   noise ? (const uint32_t*)stumble : nullptr,
                   noise ? (const uint32_t*)rand2 : nullptr, 2 + use_bits + 2 * noise};
  const int TS = tile_steps(base, st.n, N, T);
  const uintptr_t align = (uintptr_t)st.rand_a | (uintptr_t)st.u | (uintptr_t)st.bits |
                          (uintptr_t)st.stumble | (uintptr_t)st.rand2;
  const bool vec16 = N % 4 == 0 && (align & 15) == 0;
  const size_t smem = base + (size_t)2 * st.n * TS * N * 4;
  auto kernel = tabq_stoch_kernel<false, false>;
  if (smem_tables) {
    kernel = TS ? tabq_stoch_kernel<true, true> : tabq_stoch_kernel<true, false>;
  } else if (TS) {
    kernel = tabq_stoch_kernel<false, true>;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int lanes = N < kMaxThreads ? N : kMaxThreads;
  const int threads = (lanes + 31) & ~31;  // whole warps: the cell grouping is per warp
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      env, S, lr, gamma, eps0, eps_delta, anneal, (const float*)q0, (const int32_t*)idx0,
      (const int32_t*)t0, (const float*)epr0, (const float*)eph0, (const int32_t*)epl0,
      (const int64_t*)step0, st, TS, vec16 ? 1 : 0, base, T, N, (float*)q_o,
      (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o, (float*)eph_o, (int32_t*)epl_o,
      (int64_t*)step_o, (float*)eacc_o, (float*)racc_o, (float*)hacc_o, (float*)lacc_o);
  return (int)cudaGetLastError();
}
