// DQN collect: ε-greedy act from a frozen greedy row -> env step -> replay
// record, for T steps, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/dqn_kernel.py::_kernel (launched by
// dqn_collect_run through pl.pallas_call). The TPU kernel reads the tables
// AND the greedy action through one bf16 one-hot matmul against a payload
// (next index split into hi/lo bytes to stay bf16-exact), because Mosaic
// rejects per-lane gathers. Here the 13-byte-per-(s, a) tables and the
// greedy row sit in shared memory and each lane reads its own entries.
//
// What bounds it on this card: device-memory traffic is the two [T, N]
// draw streams in (8 bytes per lane and step) and the six [T, N] record
// streams out (24 bytes), so it is bytes-bound on paper; in fact one lane's
// steps are a dependent chain (greedy read -> table read -> next state), so
// the kernel is bound by that chain's latency, and at the trainer's width
// (N = 128, T = 32) by the launch. The Hopper design (B10's and B5's, in
// ppo_stoch_collect_kernel.cu and ppo_collect_kernel.cu) spreads the lanes
// wide and keeps device memory out of the chain:
//  - one warp a block, so N = 128 runs on 4 SMs and N = 4096 on 128 (the
//    first design's 128-thread blocks put them on 1 and 32);
//  - the tables (next, reward, hidden: 4 bytes an entry; done: 1) and the
//    greedy row (its int32 words) are staged with cp.async, 16 bytes a copy
//    where the arrays allow it, each array at a 16-byte aligned offset;
//  - the [T, N] draws u and rand_a are staged into shared memory in tiles
//    of 16 steps with cp.async, double-buffered: the next tile is issued
//    before the current one is walked, so no load from device memory sits
//    in a lane's chain;
//  - the six records of a tile are written to shared memory and stored
//    after the tile in bulk, 16 bytes a store where the rows allow it.
// Any T >= 0 (the last tile may be partial) and any N >= 1 (the last block
// may be partial) are taken.
//
// Where the tables and the greedy row live is a template parameter (B9's
// kPlace): shared memory when they fit one block's 227 KB beside the tiles,
// device memory otherwise (conveyor, S·A = 28,224: 395 KB), read through
// the read-only path and resident in L2. The draws and the records still go
// through the shared tiles: with the tables in device memory B9's records
// were 23% faster through the record tile than stored from the walk.
//
// Numerics: ε uses round-to-nearest intrinsics (as the tabular kernel does)
// so no FMA contraction moves a `u < ε` decision; the episode totals follow
// the reference's update order (dqn_kernel.py:155-166). Every output is
// bitwise the plain PyTorch version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async_stage.cuh"

namespace {

using stage::kThreads;  // one warp, one block
using stage::kTile;     // steps per draw and record tile
using stage::r16;
constexpr int kStreams = 2;          // u, rand_a
constexpr int kRecords = 6;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap
// The draw tiles (two buffers) and the record tile, in bytes.
constexpr size_t kTileBytes = 4 * kThreads * kTile * (2 * kStreams + kRecords);
// The output buffer: the int64 step in its first 16 bytes, then the six
// [T, N] records, then the (1, N) lanes, all 4-byte words.
constexpr size_t kHeadWords = 4;

// Byte offsets of the shared-memory arrays: the tiles, then the tables and
// the greedy row, each at a 16-byte boundary. Mirrored by
// ops/dqn_kernel.py::smem_bytes.
struct Layout {
  size_t next, reward, hidden, done, greedy, total;
};

__host__ __device__ Layout layout(int S, int A, bool smem_tables = true) {
  // In device memory the tables and the greedy row take no shared memory.
  const size_t SA = smem_tables ? (size_t)S * A : 0;
  if (!smem_tables) S = 0;
  Layout L;
  size_t at = kTileBytes;
  L.next = at;
  at += r16(4 * SA);
  L.reward = at;
  at += r16(4 * SA);
  L.hidden = at;
  at += r16(4 * SA);
  L.done = at;
  at += r16(SA);
  L.greedy = at;
  at += r16(4 * (size_t)S);
  L.total = at;
  return L;
}

// Stages the tile of u (slot 0) and rand_a (slot 1) into dst ([slot][step]
// [lane]) and commits the copies as one group.
__device__ __forceinline__ void stage_tile(uint32_t* dst, const uint32_t* u,
                                           const uint32_t* rand_a, int s0, int steps, int lane0,
                                           int n_live, int N, bool vec16) {
  stage::stream(dst, u, s0, steps, lane0, n_live, N, vec16);
  stage::stream(dst + kTile * kThreads, rand_a, s0, steps, lane0, n_live, N, vec16);
  stage::commit();
}

// A table or greedy-row read: shared memory, or device memory through the
// read-only path.
template <bool kSmem, typename V>
__device__ __forceinline__ V rd(const V* p, int i) {
  if (kSmem) return p[i];
  return __ldg(p + i);
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) dqn_collect_kernel(
    const int32_t* __restrict__ next, const float* __restrict__ reward,
    const float* __restrict__ hidden, const uint8_t* __restrict__ done_tab,
    const int32_t* __restrict__ greedy_row, int S, int A, int max_steps, int reset_idx,
    float eps0, float eps_delta, float anneal, int use_hidden,
    const int32_t* __restrict__ idx0, const int32_t* __restrict__ t0,
    const float* __restrict__ epr0, const float* __restrict__ eph0,
    const int32_t* __restrict__ epl0, const int64_t* __restrict__ step0,
    const uint32_t* __restrict__ rand_a, const uint32_t* __restrict__ u, int T, int N,
    int vec16, int64_t* __restrict__ step_o, uint32_t* __restrict__ rec,
    uint32_t* __restrict__ lanes) {
  const size_t SA = (size_t)S * A;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(S, A);
  uint32_t* s_in = reinterpret_cast<uint32_t*>(smem);               // [2][2][kTile][lanes]
  uint32_t* s_rec = s_in + 2 * kStreams * kTile * kThreads;          // [6][kTile][lanes]
  const int32_t* s_next = kSmem ? reinterpret_cast<const int32_t*>(smem + L.next) : next;
  const float* s_rew = kSmem ? reinterpret_cast<const float*>(smem + L.reward) : reward;
  const float* s_hid = kSmem ? reinterpret_cast<const float*>(smem + L.hidden) : hidden;
  const uint8_t* s_done = kSmem ? smem + L.done : done_tab;
  const int32_t* s_greedy =
      kSmem ? reinterpret_cast<const int32_t*>(smem + L.greedy) : greedy_row;

  const int lane0 = blockIdx.x * kThreads;
  const int n_live = min(kThreads, N - lane0);
  if (T > 0) stage_tile(s_in, u, rand_a, 0, min(kTile, T), lane0, n_live, N, vec16);
  if (kSmem) {
    stage::bytes(smem + L.next, next, 4 * SA);
    stage::bytes(smem + L.reward, reward, 4 * SA);
    stage::bytes(smem + L.hidden, hidden, 4 * SA);
    stage::bytes(smem + L.done, done_tab, SA);
    stage::bytes(smem + L.greedy, greedy_row, 4 * (size_t)S);
  }
  stage::commit();

  const int lane = lane0 + threadIdx.x;
  const bool live = lane < N;
  const int64_t st0 = *step0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *step_o = st0 + (int64_t)T * N;
  int idx = 0, t = 0, epl = 0;
  float epr = 0.f, eph = 0.f;
  if (live) {
    idx = idx0[lane];
    t = t0[lane];
    epl = epl0[lane];
    epr = epr0[lane];
    eph = eph0[lane];
  }
  float eacc = 0.f, racc = 0.f, hacc = 0.f, lacc = 0.f;
  stage::wait_all();
  __syncthreads();

  int cur = 0;
  for (int s0 = 0; s0 < T; s0 += kTile) {
    const int steps = min(kTile, T - s0);
    if (s0 + kTile < T)  // the next tile, into the other buffer
      stage_tile(s_in + (cur ^ 1) * kStreams * kTile * kThreads, u, rand_a, s0 + kTile,
                 min(kTile, T - s0 - kTile), lane0, n_live, N, vec16);
    const uint32_t* in = s_in + cur * kStreams * kTile * kThreads + threadIdx.x;
    if (live) {
      // A full tile's steps are unrolled, so the compiler reads their draws
      // and computes their ε ahead of the chain; a partial last tile runs
      // rolled.
      auto step = [&](const int k) {
        // Linear ε anneal from the global step counter (dqn_kernel.py:125-127).
        const int64_t step_t = st0 + (int64_t)(s0 + k) * N;
        float frac = __fdiv_rn(__ll2float_rn(step_t), anneal);
        frac = fminf(fmaxf(frac, 0.f), 1.f);
        const float eps_t = __fadd_rn(eps0, __fmul_rn(frac, eps_delta));

        const float uu = __uint_as_float(in[k * kThreads]);
        const int ra = (int)in[(kTile + k) * kThreads];
        const int act = uu < eps_t ? ra : rd<kSmem>(s_greedy, idx);
        const int j = idx * A + act;
        const int nxt = rd<kSmem>(s_next, j);
        const float r = rd<kSmem>(s_rew, j);
        const float h = rd<kSmem>(s_hid, j);
        const int t1 = t + 1;
        const bool done = rd<kSmem>(s_done, j) != 0 || t1 >= max_steps;

        // The records in the buffer's order: the int32 ones, then reward.
        uint32_t* o = s_rec + k * kThreads + threadIdx.x;
        constexpr int R = kTile * kThreads;  // one record's tile
        o[0 * R] = (uint32_t)idx;
        o[1 * R] = (uint32_t)t;
        o[2 * R] = (uint32_t)act;
        o[3 * R] = (uint32_t)nxt;
        o[4 * R] = done ? 1u : 0u;
        o[5 * R] = __float_as_uint(use_hidden ? h : r);

        const float dx = done ? 1.f : 0.f;
        epr = __fadd_rn(epr, r);
        eph = __fadd_rn(eph, h);
        epl += 1;
        eacc = __fadd_rn(eacc, dx);
        racc = __fadd_rn(racc, __fmul_rn(dx, epr));
        hacc = __fadd_rn(hacc, __fmul_rn(dx, eph));
        lacc = __fadd_rn(lacc, __fmul_rn(dx, (float)epl));
        idx = done ? reset_idx : nxt;
        t = done ? 0 : t1;
        epr = done ? 0.f : epr;
        eph = done ? 0.f : eph;
        epl = done ? 0 : epl;
      };
      if (steps == kTile) {
#pragma unroll
        for (int k = 0; k < kTile; ++k) step(k);
      } else {
        for (int k = 0; k < steps; ++k) step(k);
      }
    }
    __syncthreads();  // the record tile is complete
    if (vec16) {  // 16 bytes a store: 8 stores a full row of 32 lanes, 4 rows at a time
      const int q = 4 * (threadIdx.x % (kThreads / 4));
      if (q < n_live)
        for (int r = 0; r < kRecords; ++r)
          for (int row = threadIdx.x / (kThreads / 4); row < steps; row += 4)
            *reinterpret_cast<uint4*>(rec + (r * (size_t)T + s0 + row) * N + lane0 + q) =
                *reinterpret_cast<const uint4*>(s_rec + (r * kTile + row) * kThreads + q);
    } else if (live) {
      for (int r = 0; r < kRecords; ++r)
        for (int row = 0; row < steps; ++row)
          rec[(r * (size_t)T + s0 + row) * N + lane] =
              s_rec[(r * kTile + row) * kThreads + threadIdx.x];
    }
    stage::wait_all();  // this thread's copies of the next tile
    __syncthreads();      // ... visible to the block; the record tile free again
    cur ^= 1;
  }
  if (!live) return;
  // The lanes: idx, t, ep_len (int32), then ep_return, ep_hidden and the
  // four accumulators (float32).
  lanes[lane] = (uint32_t)idx;
  lanes[N + lane] = (uint32_t)t;
  lanes[2 * N + lane] = (uint32_t)epl;
  lanes[3 * N + lane] = __float_as_uint(epr);
  lanes[4 * N + lane] = __float_as_uint(eph);
  lanes[5 * N + lane] = __float_as_uint(eacc);
  lanes[6 * N + lane] = __float_as_uint(racc);
  lanes[7 * N + lane] = __float_as_uint(hacc);
  lanes[8 * N + lane] = __float_as_uint(lacc);
}

}  // namespace

// Bytes of shared memory a block takes for S states and A actions: the draw
// and record tiles, then, with smem_tables, the tables and the greedy row at
// 16-byte boundaries. Mirrored by ops/dqn_kernel.py::smem_bytes.
extern "C" long long dqn_collect_smem_bytes(int S, int A, int smem_tables) {
  return (long long)layout(S, A, smem_tables != 0).total;
}

// Where the tables and the greedy row go: 1 (shared memory) if they fit one
// block beside the tiles, else 0 (device memory). Mirrored by
// ops/dqn_kernel.py::placement.
extern "C" int dqn_collect_placement(int S, int A) { return layout(S, A).total <= kMaxSmem; }

// Launch on `stream`; returns cudaGetLastError() (0 on success). Actions in
// rand_a and the greedy row must lie in [0, A), indices in [0, S); T >= 0,
// N >= 1. `out` (16-byte aligned) is one buffer of 4 + 6·T·N + 9·N 4-byte
// words: the int64 step in the first two (two more pad the head to 16
// bytes), then the six [T, N] records pre_idx, pre_t, action, next_idx,
// done (int32), reward (float32), then the (1, N) lanes idx, t, ep_len
// (int32), ep_return, ep_hidden and the accumulators episodes, return,
// hidden, length (float32). Mirrored by ops/dqn_kernel.py::carve_outputs.
// smem_tables selects the placement of the tables and the greedy row (1:
// shared memory, where they must fit; 0: device memory).
extern "C" int dqn_collect_launch(
    const void* next, const void* reward, const void* hidden, const void* done_tab,
    const void* greedy_row, int S, int A, int max_steps, int reset_idx, float eps0,
    float eps_delta, float anneal, int use_hidden, const void* idx0, const void* t0,
    const void* epr0, const void* eph0, const void* epl0, const void* step0,
    const void* rand_a, const void* u, int T, int N, void* out, void* stream,
    int smem_tables) {
  if (N < 1 || T < 0 || S < 1 || A < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(S, A, smem_tables != 0).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = smem_tables ? dqn_collect_kernel<true> : dqn_collect_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  uint32_t* rec = (uint32_t*)out + kHeadWords;
  const bool vec16 =
      N % 4 == 0 && (((uintptr_t)rec | (uintptr_t)u | (uintptr_t)rand_a) & 15) == 0;
  const int blocks = (N + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)next, (const float*)reward, (const float*)hidden,
      (const uint8_t*)done_tab, (const int32_t*)greedy_row, S, A, max_steps, reset_idx, eps0,
      eps_delta, anneal, use_hidden, (const int32_t*)idx0, (const int32_t*)t0,
      (const float*)epr0, (const float*)eph0, (const int32_t*)epl0, (const int64_t*)step0,
      (const uint32_t*)rand_a, (const uint32_t*)u, T, N, vec16 ? 1 : 0, (int64_t*)out, rec,
      rec + (size_t)kRecords * T * N);
  return (int)cudaGetLastError();
}
