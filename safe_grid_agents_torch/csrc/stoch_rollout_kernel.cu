// T-step rollout of a stochastic compiled env, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/stoch_rollout_kernel.py::_kernel
// (launched by _run through pl.pallas_call): B1 (rollout_kernel.cu) plus the
// stochastic mechanics of stoch_step.cuh — coin resets (mode 1), carried
// resets (mode 2), whisky's stumble and tomato's drying — on presampled
// [T, N] int32 streams (actions, bits, stumble, rand_a). The TPU kernel reads
// the tables through a one-hot matmul over hi/lo bf16 payload rows because
// Mosaic rejects per-lane gathers; here each lane reads its entries straight
// from the tables. The lane-block and T-block tiling of _run is a VMEM
// constraint of the TPU and is not carried over: each thread loops over T.
//
// Where the tables live is a template parameter: shared memory when they
// fit in one block's 227 KB beside the stream tiles (13 bytes per (s, a),
// 21 in mode 2, plus one byte per state for the drunk row: tomato 70 KB,
// friend at cap 15 182 KB), device memory otherwise (friend at cap 127,
// ~1.5 MB, read through L2).
//
// What bounds it on this card: the device-memory traffic is the streams the
// env uses, 4 bytes per lane-step for the actions plus 4 for bits (coin or
// drying envs) and 8 for stumble and rand_a (whisky), read once; each step
// waits on the previous one through dependent table loads, so the kernel is
// bound by that latency chain rather than by bytes. The Hopper design
// (B10's, in ppo_stoch_collect_kernel.cu) spreads the lanes wide and keeps
// device memory out of the chain:
//  - one warp a block, so N = 4096 runs on 128 SMs (the first design's
//    128-thread blocks put it on 32);
//  - the streams the env reads are staged into shared memory in tiles of 16
//    steps with cp.async, double-buffered: the next tile is issued before
//    the current one is walked, so no stream load sits in a lane's chain (a
//    stream the env does not use is not read);
//  - the tables, where they fit, are staged with cp.async, 16 bytes a copy
//    where the arrays allow it, each array at a 16-byte aligned offset.
// State and accumulators stay in registers; the step itself is
// stoch_step.cuh's, shared with B8, B9 and B10 (with the tables in device
// memory, its loads hoisted: global_lane_step). Any T >= 0 (the last tile
// may be partial) and any N >= 1 (the last block may be partial) are taken.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async_stage.cuh"
#include "stoch_step.cuh"

namespace {

using stage::kThreads;  // one warp, one block
using stage::kTile;     // steps per stream tile
using stage::r16;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap
// One stream's tile in one of the two buffers, in bytes.
constexpr size_t kStreamTileBytes = 4 * kThreads * kTile;

// The streams the env reads (actions always; bits where there is a coin or
// drying; stumble and rand_a where there is noise), else null, and their
// count: a tile holds them in slots 0.. in that order.
struct Streams {
  const uint32_t *actions, *bits, *stumble, *rand_a;
  int count;
};

// Byte offsets of the shared-memory arrays: the stream tiles (two buffers),
// then, where the tables are staged, next, reward, hidden, cand0 and cand1
// (mode 2), done and drunk (noise), each at a 16-byte boundary. Mirrored by
// ops/stoch_rollout_kernel.py::smem_bytes.
struct Layout {
  size_t next, reward, hidden, cand0, cand1, done, drunk, total;
};

__host__ __device__ Layout layout(int S, int A, int mode, bool noise, int n_streams,
                                  bool tables) {
  const size_t SA = (size_t)S * A;
  Layout L;
  size_t at = 2 * n_streams * kStreamTileBytes;
  L.next = L.reward = L.hidden = L.cand0 = L.cand1 = L.done = L.drunk = at;
  if (tables) {
    L.next = at;
    at += r16(4 * SA);
    L.reward = at;
    at += r16(4 * SA);
    L.hidden = at;
    at += r16(4 * SA);
    if (mode == 2) {
      L.cand0 = at;
      at += r16(4 * SA);
      L.cand1 = at;
      at += r16(4 * SA);
    }
    L.done = at;
    at += r16(SA);
    if (noise) {
      L.drunk = at;
      at += r16(S);
    }
  }
  L.total = at;
  return L;
}

// Issues the copies of the tables of g into smem at the offsets of L and
// returns the env pointing there. The caller commits, waits and
// synchronises the block before reading.
__device__ StochEnv stage_env(const StochEnv& g, int S, const Layout& L, unsigned char* smem) {
  const size_t SA = (size_t)S * g.A;
  StochEnv s = g;
  stage::bytes(smem + L.next, g.next, 4 * SA);
  stage::bytes(smem + L.reward, g.reward, 4 * SA);
  stage::bytes(smem + L.hidden, g.hidden, 4 * SA);
  stage::bytes(smem + L.done, g.done, SA);
  s.next = reinterpret_cast<const int32_t*>(smem + L.next);
  s.reward = reinterpret_cast<const float*>(smem + L.reward);
  s.hidden = reinterpret_cast<const float*>(smem + L.hidden);
  s.done = smem + L.done;
  if (g.mode == 2) {
    stage::bytes(smem + L.cand0, g.cand0, 4 * SA);
    stage::bytes(smem + L.cand1, g.cand1, 4 * SA);
    s.cand0 = reinterpret_cast<const int32_t*>(smem + L.cand0);
    s.cand1 = reinterpret_cast<const int32_t*>(smem + L.cand1);
  }
  if (g.drunk != nullptr) {
    stage::bytes(smem + L.drunk, g.drunk, S);
    s.drunk = smem + L.drunk;
  }
  return s;
}

// Stages every used stream's tile into dst ([slot][step][lane]) and commits
// the copies as one group.
__device__ __forceinline__ void stage_tile(uint32_t* dst, const Streams& st, int s0, int steps,
                                           int lane0, int n_live, int N, bool vec16) {
  constexpr int kSlot = kTile * kThreads;
  int i = 0;
  stage::stream(dst + kSlot * i++, st.actions, s0, steps, lane0, n_live, N, vec16);
  if (st.bits != nullptr)
    stage::stream(dst + kSlot * i++, st.bits, s0, steps, lane0, n_live, N, vec16);
  if (st.stumble != nullptr) {
    stage::stream(dst + kSlot * i++, st.stumble, s0, steps, lane0, n_live, N, vec16);
    stage::stream(dst + kSlot * i, st.rand_a, s0, steps, lane0, n_live, N, vec16);
  }
  stage::commit();
}

template <bool kSmemTables>
__global__ void __launch_bounds__(kThreads) stoch_rollout_kernel(
    StochEnv genv, int S, Layout L, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0, Streams streams,
    int vec16, int T, int N, int32_t* __restrict__ idx_o, int32_t* __restrict__ t_o,
    float* __restrict__ epr_o, float* __restrict__ eph_o, int32_t* __restrict__ epl_o,
    float* __restrict__ racc_o, float* __restrict__ eacc_o, float* __restrict__ facc_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_in = reinterpret_cast<uint32_t*>(smem);  // [2][streams][kTile][lanes]
  const int buf_words = streams.count * kTile * kThreads;
  const int lane0 = blockIdx.x * kThreads;
  const int n_live = min(kThreads, N - lane0);
  if (T > 0) stage_tile(s_in, streams, 0, min(kTile, T), lane0, n_live, N, vec16);
  StochEnv env = genv;
  if (kSmemTables) {
    env = stage_env(genv, S, L, smem);
    stage::commit();
  }
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < N;
  const bool use_bits = streams.bits != nullptr;
  const bool noise = streams.stumble != nullptr;
  const int i_stumble = use_bits ? 2 : 1;
  LaneState st{0, 0, 0, 0.f, 0.f};
  if (live) st = LaneState{idx0[lane], t0[lane], epl0[lane], epr0[lane], eph0[lane]};
  float racc = 0.f, eacc = 0.f, facc = 0.f;
  stage::wait_all();
  __syncthreads();

  int cur = 0;
  for (int s0 = 0; s0 < T; s0 += kTile) {
    const int steps = min(kTile, T - s0);
    if (s0 + kTile < T)  // the next tile, into the other buffer
      stage_tile(s_in + (cur ^ 1) * buf_words, streams, s0 + kTile, min(kTile, T - s0 - kTile),
                 lane0, n_live, N, vec16);
    const uint32_t* in = s_in + cur * buf_words + threadIdx.x;
    if (live) {
      // Unrolled over the tile (a partial last tile skips its missing
      // steps), so the stream reads of later steps issue ahead of the chain.
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        if (k < steps) {
          const int a = (int)in[k * kThreads];
          const int b = use_bits ? (int)in[(kTile + k) * kThreads] : 0;
          int sm = 0, ra = 0;
          if (noise) {
            sm = (int)in[(i_stumble * kTile + k) * kThreads];
            ra = (int)in[((i_stumble + 1) * kTile + k) * kThreads];
          }
          const LaneStep o = kSmemTables ? stoch_lane_step(env, st, a, b, sm, ra)
                                         : global_lane_step(env, st, a, b, sm, ra);
          const float dx = o.done ? 1.f : 0.f;
          racc = __fadd_rn(racc, o.reward);
          eacc = __fadd_rn(eacc, dx);
          facc = __fadd_rn(facc, __fmul_rn(dx, o.epr));
        }
      }
    }
    stage::wait_all();  // this thread's copies of the next tile
    __syncthreads();      // ... visible to the block; this buffer free again
    cur ^= 1;
  }
  if (!live) return;
  idx_o[lane] = st.idx;
  t_o[lane] = st.t;
  epr_o[lane] = st.epr;
  eph_o[lane] = st.eph;
  epl_o[lane] = st.epl;
  racc_o[lane] = racc;
  eacc_o[lane] = eacc;
  facc_o[lane] = facc;
}

// The number of streams the env reads: actions, bits (a coin or drying),
// stumble and rand_a (noise).
int stream_count(int mode, int dry_nbits, bool noise) {
  return 1 + (mode != 0 || dry_nbits != 0 ? 1 : 0) + (noise ? 2 : 0);
}

}  // namespace

// Bytes of shared memory a block takes: the stream tiles for the streams
// the env reads (by mode, drying and noise) and, with smem_tables, the
// tables at 16-byte boundaries. Mirrored by
// ops/stoch_rollout_kernel.py::smem_bytes.
extern "C" long long stoch_rollout_smem_bytes(int S, int A, int mode, int dry_nbits, int noise,
                                              int smem_tables) {
  return (long long)layout(S, A, mode, noise != 0, stream_count(mode, dry_nbits, noise != 0),
                          smem_tables != 0)
      .total;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). cand0/cand1
// are read in mode 2 only; drunk may be null (no noise). smem_tables selects
// the placement of the tables (1: shared memory, 0: device memory). Actions
// and rand_a must lie in [0, A), indices in [0, S): tables are read unchecked.
extern "C" int stoch_rollout_launch(
    const void* next, const void* reward, const void* hidden, const void* done,
    const void* cand0, const void* cand1, const void* drunk, int S, int A,
    int max_steps, int mode, int r0, int r1, int dry_nbits, int smem_tables,
    const void* idx0, const void* t0, const void* epr0, const void* eph0,
    const void* epl0, const void* actions, const void* bits, const void* stumble,
    const void* rand_a, int T, int N, void* idx_o, void* t_o, void* epr_o,
    void* eph_o, void* epl_o, void* racc_o, void* eacc_o, void* facc_o,
    void* stream) {
  if (N < 1 || T < 0 || S < 1 || A < 1 || mode < 0 || mode > 2 || dry_nbits < 0 ||
      dry_nbits > 30 || (mode == 2 && (cand0 == nullptr || cand1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StochEnv env{(const int32_t*)next, (const float*)reward, (const float*)hidden,
                     (const uint8_t*)done, (const int32_t*)cand0, (const int32_t*)cand1,
                     (const uint8_t*)drunk, A, max_steps, mode, r0, r1,
                     (1 << dry_nbits) - 1};
  const bool use_bits = mode != 0 || dry_nbits != 0;
  const bool noise = drunk != nullptr;
  const Streams st{(const uint32_t*)actions, use_bits ? (const uint32_t*)bits : nullptr,
                   noise ? (const uint32_t*)stumble : nullptr,
                   noise ? (const uint32_t*)rand_a : nullptr,
                   stream_count(mode, dry_nbits, noise)};
  const Layout L = layout(S, A, mode, noise, st.count, smem_tables != 0);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  const uintptr_t align =
      (uintptr_t)st.actions | (uintptr_t)st.bits | (uintptr_t)st.stumble | (uintptr_t)st.rand_a;
  const bool vec16 = N % 4 == 0 && (align & 15) == 0;
  auto kernel = smem_tables ? stoch_rollout_kernel<true> : stoch_rollout_kernel<false>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, L.total, (cudaStream_t)stream>>>(
      env, S, L, (const int32_t*)idx0, (const int32_t*)t0, (const float*)epr0,
      (const float*)eph0, (const int32_t*)epl0, st, vec16 ? 1 : 0, T, N, (int32_t*)idx_o,
      (int32_t*)t_o, (float*)epr_o, (float*)eph_o, (int32_t*)epl_o, (float*)racc_o,
      (float*)eacc_o, (float*)facc_o);
  return (int)cudaGetLastError();
}
