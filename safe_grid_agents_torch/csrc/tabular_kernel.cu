// Fused tabular-Q training: ε-greedy act -> env step -> duplicate-averaged
// TD over all N lanes, for T steps, in one thread block.
//
// Replaces safe_grid_agents_tpu/ops/tabular_kernel.py::_kernel (launched by
// tabq_run through pl.pallas_call). The TPU kernel reads Q rows and the env
// tables through one-hot matmuls and sums the TD errors with a
// lane-contraction matmul, all to avoid per-lane gathers that Mosaic
// rejects. Here Q [S, A], the TD sums and counts [S, A] and the env tables
// sit in shared memory and each lane reads and scatters its own entries.
//
// What bounds it on this card: every step's TD sums over ALL N lanes must
// land before any lane reads Q again (the trainers' batched TD against the
// pre-update Q), so the whole batch lives in ONE thread block (1 of 132 SMs)
// with two block barriers per step. Device-memory traffic is only the
// presampled draws, 8 bytes per lane and step; the kernel is bound by the
// serial step chain (barriers, dependent shared-memory reads, shared-memory
// atomics on the few hot (s, a) cells), not by bytes or operations. The
// Hopper design (B8's, in tabular_stoch_kernel.cu) shortens each step:
//  - The draws rand_a and u do not depend on the state: they are staged
//    into shared memory with cp.async in tiles of up to kMaxTile = 32
//    steps, double-buffered, the next tile issued at the start of the
//    current one and awaited before the last barrier of its last step, so
//    no step's chain waits on device memory. The ε of each of a tile's
//    steps (a division) is computed once, when the tile is issued, one
//    step a thread. The tile depth is the largest that fits beside Q and
//    the tables (32 at the CLI's N = 64; 3 at N = 4096 on shift, 1 on
//    sokoban, the largest table).
//  - The env tables are packed in the prologue into one 16-byte word per
//    (s, a): the successor (the reset state for a done entry; its Q row is
//    then read but never used, the target's bootstrap being zeroed), the
//    reward and hidden reward, the done flag. A step makes one table load.
//  - Only the touched cells are updated. At most N of the S·A cells change
//    in a step; the first design swept all S·A cells after every step (252
//    on shift: ~4 passes of 64 threads at the CLI's N = 64, each with a
//    division). Here the count's shared-memory atomic returns 0 to exactly
//    one adder of each touched cell, which owns the cell: after the
//    barrier the owners alone apply Q += (lr · Σtd) / max(cnt, 1) and clear
//    the cell's sum and count. An untouched cell keeps its value where the
//    dense sweep added +0.0; the two differ only for a Q entry of -0.0,
//    which never arises: Q starts at +0.0 (or at values drawn away from
//    zero), and a round-to-nearest add returns -0.0 only for
//    (-0.0) + (-0.0), while every update lr·sum/cnt of a touched cell is
//    +0.0 or nonzero.
//  - Hot cells: after a reset every lane stands on the reset state, so a
//    step's TD adds land on a few cells. They are native 32-bit integer
//    shared-memory atomics (the fixed-point sums below), one set a lane;
//    grouping a warp's lanes by cell first with __match_any_sync and
//    adding once a group (B8's scheme) cost more than the atomics it saved:
//    0.120 against 0.067 ms at the CLI's N = 64, 0.158 against 0.067 from
//    a hot reset, 48.3 against 33.7 ms at N = 4096, T = 8192
//    (tools/b2_variants.py on an H100).
//  - A thread owns 1, 2 or 4 lanes (a template parameter, by N), so the
//    CLI's N = 64 runs no dead lane slots; with A = 4 (every alias) a Q row
//    is one 16-byte load.
// SGA_STAMP markers (compiled only with -DSGA_TRACE: thread 0 records
// clock64() at each, no extra barriers) split a step into act + env step,
// the TD atomics, the barrier after them, the update of the
// touched cells, and the barrier after it (tools/trace_learners.py
// --b2-stamps).
//
// Where Q and the tables live is a template parameter (B7's rule): shared
// memory when Q, the TD sums, the counts and the packed table fit one block
// with at least one step of draws, device memory otherwise (conveyor,
// S·A = 28,224: 903 KB). In device memory Q is worked in place in the
// output buffer (copied from q0 in the prologue), the 64-bit TD sums and
// the counts sit in a work area the prologue clears and the TD adds are
// native 64-bit integer atomics on them (exact in any order, so the kernel
// stays bitwise equal to the plain version), the sums and counts are read
// back from L2 (__ldcg), and the packed table, packed once by the wrapper
// (ops/tabular_kernel.py::packed_entries), is read through the read-only
// path. The touched-cell ownership, the per-tile ε and the draw tiles stay
// in shared memory; the tiles are as deep as what is left of it allows.
// Only the touched cells are cleared between steps, in both placements.
//
// Numerics: every float op of ε, the TD target, td and the Q update uses
// the round-to-nearest intrinsics, so no FMA contraction moves a `u < ε`
// decision or a td by an ulp away from the plain version. The update keeps
// the reference's association (lr * td_sum) / max(cnt, 1). The TD sums are
// not float atomics: cells whose Q should tie (two actions that bump into
// one wall) get their sums in a run-dependent order, come apart in the
// last bit, and an argmax flips and the trajectories part (a model of this
// kernel's order against the plain version's parts within 5 steps of a hot
// reset on shift). Each TD error is a 64-bit fixed-point integer (2^-32
// units, rounded to nearest even), B8's scheme: integer adds are exact in
// any order, so the kernel is deterministic and bitwise equal to the plain
// version, which sums the same integers. The sum returns to float through
// double, as the plain version converts it. Range: |TD| < 2^19 per lane at
// N <= 4096 (int64 holds 2^63). The sums are added in two 32-bit words with
// an explicit carry (add_fixed): native shared-memory atomics, where a
// float or 64-bit atomicAdd on shared memory is a compare-and-swap loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLanesPerThread = 4;  // N <= 4096
constexpr int kMaxTile = 32;           // steps per draw tile, at most
constexpr size_t kMaxSmem = 232448;    // 227 KB: a block's dynamic shared memory cap
constexpr float kTdScale = 4294967296.f;        // 2^32: TD fixed-point units
constexpr double kTdUnit = 1.0 / 4294967296.0;  // 2^-32

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

__host__ __device__ constexpr size_t r16(size_t n) { return (n + 15) & ~(size_t)15; }

// Byte offsets of the shared-memory arrays: Q and the counts (4 bytes per
// (s, a) each), the TD sums (8), the packed table (16), the ε of the two
// tile buffers, then the two draw tile buffers ([2][rand_a, u][TS][N]
// words), each at a 16-byte boundary. Mirrored by
// ops/tabular_kernel.py::smem_bytes.
struct Layout {
  size_t q, td, cnt, pack, eps, tiles, total;
  int TS;  // steps per draw tile
};

__host__ __device__ Layout layout(int S, int A, int N, int T, bool smem_tables = true) {
  const size_t SA = smem_tables ? (size_t)S * A : 0;  // no per-cell array in device memory
  Layout L;
  L.td = 0;
  L.q = r16(8 * SA);
  L.cnt = L.q + r16(4 * SA);
  L.pack = L.cnt + r16(4 * SA);
  L.eps = L.pack + 16 * SA;
  L.tiles = L.eps + 2 * 4 * kMaxTile;
  // The deepest tile, up to kMaxTile and T, whose two buffers fit beside.
  const size_t per_step = (size_t)2 * 2 * N * 4;
  size_t ts = L.tiles < kMaxSmem ? (kMaxSmem - L.tiles) / per_step : 0;
  if (ts > (size_t)kMaxTile) ts = kMaxTile;
  if (ts > (size_t)T) ts = T;
  L.TS = (int)ts;
  L.total = L.tiles + per_step * ts;
  return L;
}

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
// value, whose wrap gives the carry into the high word (B8's add_fixed).
__device__ __forceinline__ void add_fixed(unsigned long long* cell, unsigned long long v) {
  unsigned* word = reinterpret_cast<unsigned*>(cell);  // little-endian: low word first
  const unsigned lo = (unsigned)v, hi = (unsigned)(v >> 32);
  const unsigned old = atomicAdd(word, lo);
  atomicAdd(word + 1, hi + (old + lo < old ? 1u : 0u));
}

// Issues the copies of `n` words from `g` to `d`.
__device__ __forceinline__ void stage_stream(uint32_t* d, const uint32_t* g, int n,
                                             bool vec16) {
  if (vec16) {
    for (int c = 4 * threadIdx.x; c < n; c += 4 * blockDim.x) cp_async16(d + c, g + c);
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x) cp_async4(d + c, g + c);
  }
}

// Linear ε anneal from the global step counter (tabular_kernel.py:100-106).
__device__ __forceinline__ float epsilon(int64_t step_t, float eps0, float eps_delta,
                                         float anneal) {
  float frac = __fdiv_rn(__ll2float_rn(step_t), anneal);
  frac = fminf(fmaxf(frac, 0.f), 1.f);
  return __fadd_rn(eps0, __fmul_rn(frac, eps_delta));
}

// Issues the copies of steps [s0, s0 + steps) of rand_a and u into `dst`
// (rand_a at dst, u at dst + TS·N) and commits them as one group; threads
// 0.. steps-1 write the ε of those steps to `eps`.
__device__ __forceinline__ void stage_tile(uint32_t* dst, float* eps, const uint32_t* rand_a,
                                           const uint32_t* u, int s0, int steps, int N, int TS,
                                           bool vec16, int64_t st0, float eps0,
                                           float eps_delta, float anneal) {
  const size_t at = (size_t)s0 * N;
  stage_stream(dst, rand_a + at, steps * N, vec16);
  stage_stream(dst + (size_t)TS * N, u + at, steps * N, vec16);
  cp_async_commit();
  if ((int)threadIdx.x < steps)
    eps[threadIdx.x] =
        epsilon(st0 + (int64_t)(s0 + (int)threadIdx.x) * N, eps0, eps_delta, anneal);
}

// The first-max action of the row of Q at `q` (ties to the lowest), from
// one 16-byte load when A = 4.
__device__ __forceinline__ int greedy_of(const float* q, int A) {
  if (A == 4) {
    const float4 v = *reinterpret_cast<const float4*>(q);
    int g = 0;
    float m = v.x;
    if (v.y > m) { m = v.y; g = 1; }
    if (v.z > m) { m = v.z; g = 2; }
    if (v.w > m) g = 3;
    return g;
  }
  int g = 0;
  float m = q[0];
  for (int a = 1; a < A; ++a) {
    if (q[a] > m) { m = q[a]; g = a; }
  }
  return g;
}

// The largest value of the row of Q at `q`.
__device__ __forceinline__ float max_of(const float* q, int A) {
  if (A == 4) {
    const float4 v = *reinterpret_cast<const float4*>(q);
    return fmaxf(fmaxf(fmaxf(v.x, v.y), v.z), v.w);
  }
  float m = q[0];
  for (int a = 1; a < A; ++a) m = fmaxf(m, q[a]);
  return m;
}

template <int kLanes, bool kSmem>
__global__ void __launch_bounds__(kMaxThreads) tabq_kernel(
    const int32_t* __restrict__ next, const float* __restrict__ reward,
    const float* __restrict__ hidden, const uint8_t* __restrict__ done_tab,
    int S, int A, int max_steps, int reset_idx,
    float lr, float gamma, float eps0, float eps_delta, float anneal,
    const float* __restrict__ q0, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0,
    const int64_t* __restrict__ step0, const uint32_t* __restrict__ rand_a,
    const uint32_t* __restrict__ u, int T, int N, int vec16,
    float* __restrict__ q_o, int32_t* __restrict__ idx_o,
    int32_t* __restrict__ t_o, float* __restrict__ epr_o,
    float* __restrict__ eph_o, int32_t* __restrict__ epl_o,
    int64_t* __restrict__ step_o, float* __restrict__ eacc_o,
    float* __restrict__ racc_o, float* __restrict__ hacc_o,
    float* __restrict__ lacc_o, unsigned char* __restrict__ gwork,
    const uint4* __restrict__ gpack) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SA = S * A;
  const Layout L = layout(S, A, N, T, kSmem);
  const int TS = L.TS;
  // Q, the TD sums, the counts and the packed table: in shared memory, or
  // in device memory (Q in place in q_o; the sums and counts in the work
  // area; the packed table as the wrapper packed it).
  unsigned long long* s_td = kSmem ? reinterpret_cast<unsigned long long*>(smem + L.td)
                                   : reinterpret_cast<unsigned long long*>(gwork);
  float* s_q = kSmem ? reinterpret_cast<float*>(smem + L.q) : q_o;
  unsigned* s_cnt = kSmem ? reinterpret_cast<unsigned*>(smem + L.cnt)
                          : reinterpret_cast<unsigned*>(gwork + 8 * (size_t)SA);
  uint4* s_pack = reinterpret_cast<uint4*>(smem + L.pack);
  float* s_eps = reinterpret_cast<float*>(smem + L.eps);  // [2][kMaxTile]
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem + L.tiles);  // [2][2][TS][N]
  const int64_t st0 = *step0;
  if (T > 0)
    stage_tile(tiles, s_eps, rand_a, u, 0, min(TS, T), N, TS, vec16, st0, eps0, eps_delta,
               anneal);
  for (int c = threadIdx.x; c < SA; c += blockDim.x) {
    if (kSmem) {
      const bool d = done_tab[c] != 0;
      s_pack[c] = make_uint4((unsigned)(d ? reset_idx : next[c]), __float_as_uint(reward[c]),
                             __float_as_uint(hidden[c]), d ? 1u : 0u);
    }
    s_q[c] = q0[c];
    s_td[c] = 0ull;
    s_cnt[c] = 0u;
  }

  int idx[kLanes], t[kLanes], epl[kLanes];
  float epr[kLanes], eph[kLanes];
  float eacc[kLanes], racc[kLanes], hacc[kLanes], lacc[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int lane = threadIdx.x + j * blockDim.x;
    const bool live = lane < N;
    idx[j] = live ? idx0[lane] : 0;
    t[j] = live ? t0[lane] : 0;
    epl[j] = live ? epl0[lane] : 0;
    epr[j] = live ? epr0[lane] : 0.f;
    eph[j] = live ? eph0[lane] : 0.f;
    eacc[j] = racc[j] = hacc[j] = lacc[j] = 0.f;
  }
  if (T > 0) cp_async_wait_all();
  __syncthreads();

  const size_t tsn = (size_t)TS * N;
  int tile0 = 0, cur = 0;  // the current tile's first step and buffer
  for (int s = 0; s < T; ++s) {
    SGA_STAMP(0);
    if (s == tile0 && tile0 + TS < T)  // the next tile, into the other buffer
      stage_tile(tiles + (size_t)(cur ^ 1) * 2 * tsn, s_eps + (cur ^ 1) * kMaxTile, rand_a,
                 u, tile0 + TS, min(TS, T - tile0 - TS), N, TS, vec16, st0, eps0, eps_delta,
                 anneal);
    // This step's rows of the staged tile: rand_a at ra_row, u at ra_row + TS·N.
    const uint32_t* ra_row = tiles + (size_t)cur * 2 * tsn + (size_t)(s - tile0) * N;
    const uint32_t* u_row = ra_row + tsn;
    const float eps_t = s_eps[cur * kMaxTile + (s - tile0)];

    // Phase 1a: act, step, TD against the pre-update Q, episode accounting.
    int cell[kLanes];
    long long td_fx[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int lane = threadIdx.x + j * blockDim.x;
      cell[j] = -1;
      td_fx[j] = 0;
      if (lane >= N) continue;
      const float* qrow = s_q + idx[j] * A;
      const int greedy = greedy_of(qrow, A);
      const int act = __uint_as_float(u_row[lane]) < eps_t ? (int)ra_row[lane] : greedy;
      const int k = idx[j] * A + act;
      const uint4 e = kSmem ? s_pack[k] : __ldg(gpack + k);
      const int nxt = (int)e.x;  // the reset state where the entry is done
      const float r = __uint_as_float(e.y);
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
    }
    SGA_STAMP(1);
    // Phase 1b: each lane adds its TD error and a count of one to its cell;
    // the lane whose count atomic returns 0 owns the cell for phase 2.
#pragma unroll
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
    SGA_STAMP(2);
    __syncthreads();
    SGA_STAMP(3);
    // Phase 2: each touched cell's owner applies
    // Q += (lr · td_sum) / max(cnt, 1) and clears the cell's sum and count.
#pragma unroll
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
    SGA_STAMP(4);
    const bool tile_ends = s + 1 == tile0 + TS;
    if (tile_ends && s + 1 < T) cp_async_wait_all();  // this thread's next tile
    __syncthreads();  // the update (and the next tile) visible to every lane
    SGA_STAMP(5);
    if (tile_ends) {
      tile0 += TS;
      cur ^= 1;
    }
  }

  if (kSmem)
    for (int c = threadIdx.x; c < SA; c += blockDim.x) q_o[c] = s_q[c];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int lane = threadIdx.x + j * blockDim.x;
    if (lane >= N) continue;
    idx_o[lane] = idx[j];
    t_o[lane] = t[j];
    epr_o[lane] = epr[j];
    eph_o[lane] = eph[j];
    epl_o[lane] = epl[j];
    eacc_o[lane] = eacc[j];
    racc_o[lane] = racc[j];
    hacc_o[lane] = hacc[j];
    lacc_o[lane] = lacc[j];
  }
  if (threadIdx.x == 0) *step_o = st0 + (int64_t)T * N;
}

}  // namespace

#ifdef SGA_TRACE
// Copies the first n stamps ([step][marker], 8 a step) to `host`.
extern "C" int tabq_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * sizeof(long long));
}
#endif

// Bytes of shared memory, and steps per draw tile, of a launch at these
// shapes with Q and the tables in shared memory (smem_tables) or in device
// memory. Mirrored by ops/tabular_kernel.py::smem_bytes and tile_steps.
extern "C" long long tabq_smem_bytes(int S, int A, int N, int T, int smem_tables) {
  return (long long)layout(S, A, N, T, smem_tables != 0).total;
}
extern "C" int tabq_tile_steps(int S, int A, int N, int T, int smem_tables) {
  return layout(S, A, N, T, smem_tables != 0).TS;
}

// Where Q and the tables go: 1 (shared memory) if they fit one block with
// one step of draws, else 0 (device memory). Mirrored by
// ops/tabular_kernel.py::placement.
extern "C" int tabq_placement(int S, int A, int N) {
  return layout(S, A, N, 1).TS >= 1;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). Needs
// 1 <= N <= 4096; actions drawn in rand_a and all indices must be in range.
// `gwork` null: Q, its sums and counts and the packed table go to shared
// memory with at least one step of draws (they must fit). Else Q is worked
// in q_o, `gwork` (16-byte aligned) is a work area of 12·S·A bytes (the
// int64 TD sums, then the uint32 counts; the kernel clears it) and `gpack`
// the [S·A] 16-byte packed table (16-byte aligned); the raw tables are not
// read.
extern "C" int tabq_launch(
    const void* next, const void* reward, const void* hidden,
    const void* done_tab, int S, int A, int max_steps, int reset_idx,
    float lr, float gamma, float eps0, float eps_delta, float anneal,
    const void* q0, const void* idx0, const void* t0, const void* epr0,
    const void* eph0, const void* epl0, const void* step0,
    const void* rand_a, const void* u, int T, int N,
    void* q_o, void* idx_o, void* t_o, void* epr_o, void* eph_o, void* epl_o,
    void* step_o, void* eacc_o, void* racc_o, void* hacc_o, void* lacc_o,
    void* stream, void* gwork, const void* gpack) {
  if (S < 1 || A < 1 || N < 1 || N > kMaxThreads * kMaxLanesPerThread || T < 0)
    return (int)cudaErrorInvalidValue;
  const bool smem_tables = gwork == nullptr;
  const Layout L = layout(S, A, N, T, smem_tables);
  if (L.total > kMaxSmem || (T > 0 && L.TS < 1)) return (int)cudaErrorInvalidValue;
  if (!smem_tables && (gpack == nullptr || (((uintptr_t)gwork | (uintptr_t)gpack |
                                             (uintptr_t)q_o) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const bool vec16 =
      N % 4 == 0 && (((uintptr_t)rand_a | (uintptr_t)u) & 15) == 0;
  const int lanes = N < kMaxThreads ? N : kMaxThreads;
  const int threads = (lanes + 31) & ~31;  // whole warps
  const int per = (N + threads - 1) / threads;
  auto kernel = smem_tables
                    ? (per == 1 ? tabq_kernel<1, true>
                                : per == 2 ? tabq_kernel<2, true> : tabq_kernel<4, true>)
                    : (per == 1 ? tabq_kernel<1, false>
                                : per == 2 ? tabq_kernel<2, false> : tabq_kernel<4, false>);
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<1, threads, L.total, (cudaStream_t)stream>>>(
      (const int32_t*)next, (const float*)reward, (const float*)hidden,
      (const uint8_t*)done_tab, S, A, max_steps, reset_idx,
      lr, gamma, eps0, eps_delta, anneal,
      (const float*)q0, (const int32_t*)idx0, (const int32_t*)t0,
      (const float*)epr0, (const float*)eph0, (const int32_t*)epl0,
      (const int64_t*)step0, (const uint32_t*)rand_a, (const uint32_t*)u, T, N, vec16 ? 1 : 0,
      (float*)q_o, (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o,
      (float*)eph_o, (int32_t*)epl_o, (int64_t*)step_o, (float*)eacc_o,
      (float*)racc_o, (float*)hacc_o, (float*)lacc_o, (unsigned char*)gwork,
      (const uint4*)gpack);
  return (int)cudaGetLastError();
}
