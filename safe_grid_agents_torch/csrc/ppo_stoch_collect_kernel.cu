// PPO collect on a stochastic compiled env: inverse-CDF act from frozen
// policy rows -> env step with the stochastic mechanics -> rollout records,
// for T steps, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/ppo_stoch_collect_kernel.py::_kernel
// (launched by ppo_stoch_collect_run through pl.pallas_call): the lane's
// state and episode sums in registers, the whole T loop inside the thread,
// with B7's per-lane step from stoch_step.cuh — coin resets (mode 1),
// carried resets (mode 2), whisky's stumble, tomato's drying. The policy
// rows (logp, cdf, value) are read at the index the agent observed
// (pre-dry); the record stores the CHOSEN action and its logp; the
// EFFECTIVE action (whisky's stumble) steps the env at the DRIED index. The
// TPU kernel reads tables and rows through f32 one-hot matmuls against a
// payload, because Mosaic rejects per-lane gathers; here each lane reads
// its own entries.
//
// Where the policy rows (4·S·2A bytes: 43 KB for tomato, 571 KB for friend
// at cap 127) and the tables live is a template parameter: both in shared
// memory when they fit in one block beside the stream and record tiles,
// both in device memory otherwise (read through L1/L2).
//
// The Hopper design. One lane's steps are a dependent chain (cdf compare ->
// table read -> next state), so the kernel is bound by that chain's latency
// and spreads the lanes wide: one warp a block (N = 1024 on 32 SMs, the
// first design's 128-thread blocks put it on 8). The four [T, N] draw
// streams do not depend on the state: each block stages its lanes' tile
// of the streams (TB_PS = 16 steps) into shared memory with cp.async,
// double-buffered, the next tile issued before the current one is walked,
// so no global load sits in the chain. The nine records of a tile are
// written to shared memory and stored after the tile in bulk, 16 bytes a
// store where the rows allow it. Streams an env does not use are not read.
//
// Numerics: the action is Σ_{k<A-1} (u >= cdf[idx, k]); every recorded
// float is a gather of a precomputed row or table entry, and the episode
// sums run in step order with round-to-nearest adds, so every output is
// bitwise the plain PyTorch version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stoch_step.cuh"

namespace {

constexpr int kThreads = 32;         // one warp, one block
constexpr int kTile = 16;            // TB_PS: steps per stream and record tile
constexpr int kRecords = 9;
constexpr int kMaxStreams = 4;       // u, bits, stumble, rand_a
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap
// The stream tiles (two buffers) and the record tile, in bytes.
constexpr size_t kTileBytes = 4 * kThreads * kTile * (2 * kMaxStreams + kRecords);

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

// The streams the env reads: u always, bits (coin or drying) and stumble,
// rand_a (noise) where the env uses them, else null. A tile holds u in
// slot 0, bits in slot 1, stumble and rand_a in slots 2, 3 (1, 2 without
// bits).
struct Streams {
  const uint32_t *u, *bits, *stumble, *rand_a;
};

// Issues the copies of the block's lanes [lane0, lane0 + kThreads) of steps
// [s0, s0 + kTile) of stream `g` into `d` ([step][lane]). vec16: N % 4 == 0
// and 16-byte aligned streams.
__device__ __forceinline__ void stage_stream(uint32_t* d, const uint32_t* g, int s0,
                                             int lane0, int N, bool vec16) {
  const int live = min(kThreads, N - lane0);
  if (vec16) {  // 8 copies of 16 bytes a full row, a row per 8 threads
    for (int c = threadIdx.x; c < kTile * (kThreads / 4); c += kThreads) {
      const int row = c / (kThreads / 4), q = 4 * (c % (kThreads / 4));
      if (q < live) cp_async16(d + row * kThreads + q, g + (size_t)(s0 + row) * N + lane0 + q);
    }
  } else if ((int)threadIdx.x < live) {
    for (int row = 0; row < kTile; ++row)
      cp_async4(d + row * kThreads + threadIdx.x,
                g + (size_t)(s0 + row) * N + lane0 + threadIdx.x);
  }
}

// Stages every used stream's tile into `dst` ([slot][step][lane]) and
// commits the copies as one group.
__device__ __forceinline__ void stage_tile(uint32_t* dst, const Streams& st, int s0,
                                           int lane0, int N, bool vec16) {
  constexpr int kSlot = kTile * kThreads;
  stage_stream(dst, st.u, s0, lane0, N, vec16);
  if (st.bits != nullptr) stage_stream(dst + kSlot, st.bits, s0, lane0, N, vec16);
  if (st.stumble != nullptr) {
    const int i = st.bits != nullptr ? 2 : 1;
    stage_stream(dst + i * kSlot, st.stumble, s0, lane0, N, vec16);
    stage_stream(dst + (i + 1) * kSlot, st.rand_a, s0, lane0, N, vec16);
  }
  cp_async_commit();
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) ppo_stoch_collect_kernel(
    StochEnv genv, int S, const float* __restrict__ logp_row,
    const float* __restrict__ cdf_row, const float* __restrict__ value_row,
    const int32_t* __restrict__ idx0, const int32_t* __restrict__ t0,
    const float* __restrict__ epr0, const float* __restrict__ eph0,
    const int32_t* __restrict__ epl0, Streams streams, int vec16, size_t tile_at, int T,
    int N, uint32_t* __restrict__ rec, int32_t* __restrict__ idx_o, int32_t* __restrict__ t_o,
    float* __restrict__ epr_o, float* __restrict__ eph_o, int32_t* __restrict__ epl_o,
    float* __restrict__ eacc_o, float* __restrict__ racc_o, float* __restrict__ hacc_o,
    float* __restrict__ lacc_o) {
  const int A = genv.A;
  const int SA = S * A;
  const int C = A - 1;  // cdf entries per state
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_in = reinterpret_cast<uint32_t*>(smem + tile_at);  // [2][streams][kTile][lanes]
  uint32_t* s_rec = s_in + 2 * kMaxStreams * kTile * kThreads;    // [kRecords][kTile][lanes]
  const int lane0 = blockIdx.x * kThreads;
  stage_tile(s_in, streams, 0, lane0, N, vec16);
  StochEnv env = genv;
  const float* lp = logp_row;
  const float* cd = cdf_row;
  const float* vl = value_row;
  if (kSmem) {
    // The rows first (4-byte arrays), then the tables as stage_tables lays
    // them out.
    float* s_logp = reinterpret_cast<float*>(smem);
    float* s_cdf = s_logp + SA;
    float* s_val = s_cdf + S * C;
    for (int c = threadIdx.x; c < SA; c += blockDim.x) s_logp[c] = logp_row[c];
    for (int c = threadIdx.x; c < S * C; c += blockDim.x) s_cdf[c] = cdf_row[c];
    for (int c = threadIdx.x; c < S; c += blockDim.x) s_val[c] = value_row[c];
    env = stage_tables(genv, S, reinterpret_cast<unsigned char*>(s_val + S));
    lp = s_logp;
    cd = s_cdf;
    vl = s_val;
  }
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < N;
  const bool use_bits = env.mode != 0 || env.dry_mask != 0;
  const bool noise = env.drunk != nullptr;
  const int i_stumble = use_bits ? 2 : 1;
  LaneState st{0, 0, 0, 0.f, 0.f};
  if (live) st = LaneState{idx0[lane], t0[lane], epl0[lane], epr0[lane], eph0[lane]};
  float eacc = 0.f, racc = 0.f, hacc = 0.f, lacc = 0.f;
  // Full rows of a tile (N % 4 == 0 and whole 16-byte groups of lanes) are
  // stored 16 bytes at a time.
  const int n_live = min(kThreads, N - lane0);
  cp_async_wait_all();
  __syncthreads();

  int cur = 0;
  for (int s0 = 0; s0 < T; s0 += kTile) {
    if (s0 + kTile < T)  // the next tile, into the other buffer
      stage_tile(s_in + (cur ^ 1) * kMaxStreams * kTile * kThreads, streams, s0 + kTile, lane0,
                 N, vec16);
    const uint32_t* in = s_in + cur * kMaxStreams * kTile * kThreads + threadIdx.x;
    if (live) {
      for (int k = 0; k < kTile; ++k) {
        const int pidx = st.idx, pt = st.t;
        const float uu = __uint_as_float(in[k * kThreads]);
        const float* cdf = cd + pidx * C;
        int act = 0;  // the CHOSEN action
        for (int c = 0; c < C; ++c) act += uu >= cdf[c] ? 1 : 0;
        const int b = use_bits ? (int)in[(kTile + k) * kThreads] : 0;
        int sm = 0, ra = 0;
        if (noise) {
          sm = (int)in[(i_stumble * kTile + k) * kThreads];
          ra = (int)in[((i_stumble + 1) * kTile + k) * kThreads];
        }
        const LaneStep o = stoch_lane_step(env, st, act, b, sm, ra);

        // The records in the buffer's order: the int32 ones, then the floats.
        uint32_t* r = s_rec + k * kThreads + threadIdx.x;
        constexpr int R = kTile * kThreads;  // one record's tile
        r[0 * R] = (uint32_t)pidx;
        r[1 * R] = (uint32_t)pt;
        r[2 * R] = (uint32_t)act;
        r[3 * R] = o.done ? 1u : 0u;
        r[4 * R] = (uint32_t)o.nxt;
        r[5 * R] = __float_as_uint(lp[pidx * A + act]);
        r[6 * R] = __float_as_uint(vl[pidx]);
        r[7 * R] = __float_as_uint(o.reward);
        r[8 * R] = __float_as_uint(o.hidden);

        const float dx = o.done ? 1.f : 0.f;
        eacc = __fadd_rn(eacc, dx);
        racc = __fadd_rn(racc, __fmul_rn(dx, o.epr));
        hacc = __fadd_rn(hacc, __fmul_rn(dx, o.eph));
        lacc = __fadd_rn(lacc, __fmul_rn(dx, (float)o.epl));
      }
    }
    __syncthreads();  // the record tile is complete
    if (vec16) {  // 16 bytes a store: 8 stores a full row of 32 lanes
      for (int c = threadIdx.x; c < kRecords * kTile * (kThreads / 4); c += kThreads) {
        const int q = 4 * (c % (kThreads / 4)), row = (c / (kThreads / 4)) % kTile;
        const int r = c / (kTile * (kThreads / 4));
        if (q < n_live)
          *reinterpret_cast<uint4*>(rec + (r * (size_t)T + s0 + row) * N + lane0 + q) =
              *reinterpret_cast<const uint4*>(s_rec + (r * kTile + row) * kThreads + q);
      }
    } else if (live) {
      for (int r = 0; r < kRecords; ++r)
        for (int row = 0; row < kTile; ++row)
          rec[(r * (size_t)T + s0 + row) * N + lane] =
              s_rec[(r * kTile + row) * kThreads + threadIdx.x];
    }
    cp_async_wait_all();  // this thread's copies of the next tile
    __syncthreads();      // ... visible to the block; the record tile free again
    cur ^= 1;
  }
  if (!live) return;
  idx_o[lane] = st.idx;
  t_o[lane] = st.t;
  epr_o[lane] = st.epr;
  eph_o[lane] = st.eph;
  epl_o[lane] = st.epl;
  eacc_o[lane] = eacc;
  racc_o[lane] = racc;
  hacc_o[lane] = hacc;
  lacc_o[lane] = lacc;
}

}  // namespace

// Bytes of the stream and record tiles a block keeps in shared memory beside
// the policy rows and tables. Mirrored by
// ops/ppo_stoch_collect_kernel.py::TILE_BYTES.
extern "C" long long ppo_stoch_collect_tile_bytes() { return (long long)kTileBytes; }

// Launch on `stream`; returns cudaGetLastError() (0 on success). cand0/cand1
// are read in mode 2 only; drunk may be null (no noise). smem_rows selects
// the placement of the policy rows and the tables (1: shared memory, 0:
// device memory). A >= 2; T a multiple of 16; actions drawn in rand_a and
// all indices must be in range: tables and rows are read unchecked. `out`
// is one buffer of 9·T·N + 9·N 4-byte words: the nine [T, N] records in
// the order pre_idx, pre_t, action, done, next_idx (int32), logp, value,
// reward, hidden (float32), then the (1, N) lanes idx, t, ep_len (int32),
// ep_return, ep_hidden and the four accumulators episodes, return,
// hidden, length (float32). Mirrored by
// ops/ppo_stoch_collect_kernel.py::carve_outputs.
extern "C" int ppo_stoch_collect_launch(
    const void* next, const void* reward, const void* hidden, const void* done,
    const void* cand0, const void* cand1, const void* drunk, int S, int A,
    int max_steps, int mode, int r0, int r1, int dry_nbits, int smem_rows,
    const void* logp_row, const void* cdf_row, const void* value_row, const void* idx0,
    const void* t0, const void* epr0, const void* eph0, const void* epl0, const void* u,
    const void* bits, const void* stumble, const void* rand_a, int T, int N, void* out,
    void* stream) {
  if (N < 1 || T < 0 || T % kTile || A < 2 || mode < 0 || mode > 2 || dry_nbits < 0 ||
      dry_nbits > 30 || (mode == 2 && (cand0 == nullptr || cand1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StochEnv env{(const int32_t*)next, (const float*)reward, (const float*)hidden,
                     (const uint8_t*)done, (const int32_t*)cand0, (const int32_t*)cand1,
                     (const uint8_t*)drunk, A, max_steps, mode, r0, r1,
                     (1 << dry_nbits) - 1};
  const bool noise = drunk != nullptr;
  const bool use_bits = mode != 0 || dry_nbits != 0;
  const Streams st{(const uint32_t*)u, use_bits ? (const uint32_t*)bits : nullptr,
                   noise ? (const uint32_t*)stumble : nullptr,
                   noise ? (const uint32_t*)rand_a : nullptr};
  uint32_t* rec = (uint32_t*)out;  // the nine records, then the lanes
  uint32_t* lanes = rec + kRecords * (size_t)T * N;
  const uintptr_t align = (uintptr_t)out | (uintptr_t)st.u | (uintptr_t)st.bits |
                          (uintptr_t)st.stumble | (uintptr_t)st.rand_a;
  const bool vec16 = N % 4 == 0 && (align & 15) == 0;
  size_t tile_at = smem_rows ? (size_t)S * 2 * A * 4 +
                                   stoch_table_bytes(S, A, mode, drunk != nullptr)
                             : 0;
  tile_at = (tile_at + 15) & ~(size_t)15;
  const size_t smem = tile_at + kTileBytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = smem_rows ? ppo_stoch_collect_kernel<true> : ppo_stoch_collect_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      env, S, (const float*)logp_row, (const float*)cdf_row, (const float*)value_row,
      (const int32_t*)idx0, (const int32_t*)t0, (const float*)epr0, (const float*)eph0,
      (const int32_t*)epl0, st, vec16 ? 1 : 0, tile_at, T, N, rec, (int32_t*)lanes,
      (int32_t*)(lanes + N), (float*)(lanes + 3 * N), (float*)(lanes + 4 * N),
      (int32_t*)(lanes + 2 * N), (float*)(lanes + 5 * N), (float*)(lanes + 6 * N),
      (float*)(lanes + 7 * N), (float*)(lanes + 8 * N));
  return (int)cudaGetLastError();
}
