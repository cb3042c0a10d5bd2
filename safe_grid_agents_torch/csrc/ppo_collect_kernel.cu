// PPO collect: inverse-CDF act from frozen policy rows -> env step ->
// rollout records, for T steps, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/ppo_collect_kernel.py::_kernel
// (launched by ppo_collect_run through pl.pallas_call). The TPU kernel reads
// the env tables AND the policy rows (logp, cdf, value) through one f32
// one-hot matmul per step against a payload, because Mosaic rejects
// per-lane gathers. Here the 13-byte-per-(s, a) tables and the rows
// (4·S·(2A) bytes: logp [S, A], cdf [S, A-1], value [S]) sit in shared
// memory — 6 KB for island, 109 KB for sokoban — and each lane reads its
// own entries.
//
// What bounds it on this card: device-memory traffic is the [T, N] uniform
// stream in (4 bytes per lane and step) and nine [T, N] record streams out
// (36 bytes), so it is bytes-bound on paper; in fact one lane's steps are a
// dependent chain (row compare -> table read -> next state), so the kernel
// is bound by that chain's latency. The Hopper design (B10's, in
// ppo_stoch_collect_kernel.cu) spreads the lanes wide and keeps device
// memory out of the chain:
//  - one warp a block, so the island preset's N = 1024 runs on 32 SMs (the
//    first design's 128-thread blocks put it on 8);
//  - the tables and rows are staged with cp.async (16 bytes a copy where
//    the arrays allow it), each array at a 16-byte aligned offset;
//  - the [T, N] uniforms are staged into shared memory in tiles of 16 steps
//    with cp.async, double-buffered: the next tile is issued before the
//    current one is walked, so no load from device memory sits in a lane's
//    chain;
//  - the nine records of a tile are written to shared memory and stored
//    after the tile in bulk, 16 bytes a store where the rows allow it.
// Any T >= 0 (the last tile may be partial) and any N >= 1 (the last block
// may be partial) are taken.
//
// Where the tables and the rows live is a template parameter (B10's
// kSmem): shared memory when they fit one block's 227 KB beside the tiles,
// device memory otherwise (conveyor, S·A = 28,224: 367 KB of tables and
// 254 KB of rows), read through the read-only path and resident in L2; the
// uniforms and the records still go through the shared tiles.
//
// Numerics: the action is Σ_{k<A-1} (u >= cdf[idx, k]); every recorded float
// is a gather of a precomputed row or table entry, and the episode totals
// follow the reference's update order (ppo_collect_kernel.py:119-130) in
// round-to-nearest intrinsics, so every output is bitwise the plain PyTorch
// version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;         // one warp, one block
constexpr int kTile = 16;            // steps per uniform and record tile
constexpr int kRecords = 9;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap
// The uniform tiles (two buffers) and the record tile, in bytes.
constexpr size_t kTileBytes = 4 * kThreads * kTile * (2 + kRecords);

__host__ __device__ constexpr size_t r16(size_t n) { return (n + 15) & ~(size_t)15; }

// Byte offsets of the shared-memory arrays: the tiles, then the tables and
// rows, each at a 16-byte boundary. Mirrored by
// ops/ppo_collect_kernel.py::smem_bytes.
struct Layout {
  size_t next, reward, hidden, logp, cdf, value, done, total;
};

__host__ __device__ Layout layout(int S, int A, bool smem_tables = true) {
  // In device memory the tables and the rows take no shared memory.
  if (!smem_tables) S = 0;
  const size_t SA = (size_t)S * A;
  Layout L;
  size_t at = kTileBytes;
  L.next = at;
  at += r16(4 * SA);
  L.reward = at;
  at += r16(4 * SA);
  L.hidden = at;
  at += r16(4 * SA);
  L.logp = at;
  at += r16(4 * SA);
  L.cdf = at;
  at += r16(4 * (size_t)S * (A - 1));
  L.value = at;
  at += r16(4 * (size_t)S);
  L.done = at;
  at += r16(SA);
  L.total = at;
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

// Issues the copy of n bytes from src into dst (16-byte aligned): 16 bytes
// a copy where src is 16-byte aligned, 4 where it is 4-byte aligned, the
// tail bytes by plain loads and stores.
__device__ void stage_bytes(unsigned char* dst, const unsigned char* src, size_t n) {
  const uintptr_t a = (uintptr_t)src;
  const size_t w = (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
  const size_t body = w == 1 ? 0 : n / w * w;
  for (size_t i = threadIdx.x * w; i < body; i += kThreads * w) {
    if (w == 16)
      cp_async16(dst + i, src + i);
    else
      cp_async4(dst + i, src + i);
  }
  for (size_t i = body + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// Issues the copies of the block's lanes [lane0, lane0 + n_live) of steps
// [s0, s0 + steps) of u into d ([step][lane]). vec16: N % 4 == 0 and u
// 16-byte aligned.
__device__ __forceinline__ void stage_u(float* d, const float* u, int s0, int steps, int lane0,
                                        int n_live, int N, bool vec16) {
  if (vec16) {  // 8 copies of 16 bytes a full row, a row per 8 threads
    for (int c = threadIdx.x; c < steps * (kThreads / 4); c += kThreads) {
      const int row = c / (kThreads / 4), q = 4 * (c % (kThreads / 4));
      if (q < n_live) cp_async16(d + row * kThreads + q, u + (size_t)(s0 + row) * N + lane0 + q);
    }
  } else if ((int)threadIdx.x < n_live) {
    for (int row = 0; row < steps; ++row)
      cp_async4(d + row * kThreads + threadIdx.x,
                u + (size_t)(s0 + row) * N + lane0 + threadIdx.x);
  }
  cp_async_commit();
}

// A table or row read: shared memory, or device memory through the
// read-only path.
template <bool kSmem, typename V>
__device__ __forceinline__ V rd(const V* p, int i) {
  if (kSmem) return p[i];
  return __ldg(p + i);
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) ppo_collect_kernel(
    const int32_t* __restrict__ next, const float* __restrict__ reward,
    const float* __restrict__ hidden, const uint8_t* __restrict__ done_tab,
    const float* __restrict__ logp_row, const float* __restrict__ cdf_row,
    const float* __restrict__ value_row, int S, int A, int max_steps, int reset_idx,
    const int32_t* __restrict__ idx0, const int32_t* __restrict__ t0,
    const float* __restrict__ epr0, const float* __restrict__ eph0,
    const int32_t* __restrict__ epl0, const float* __restrict__ u, int T, int N, int vec16,
    uint32_t* __restrict__ rec, uint32_t* __restrict__ lanes) {
  const int SA = S * A;
  const int C = A - 1;  // cdf entries per state
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(S, A);
  float* s_u = reinterpret_cast<float*>(smem);            // [2][kTile][lanes]
  uint32_t* s_rec = reinterpret_cast<uint32_t*>(s_u + 2 * kTile * kThreads);  // [9][kTile][lanes]
  const int32_t* s_next = kSmem ? reinterpret_cast<const int32_t*>(smem + L.next) : next;
  const float* s_rew = kSmem ? reinterpret_cast<const float*>(smem + L.reward) : reward;
  const float* s_hid = kSmem ? reinterpret_cast<const float*>(smem + L.hidden) : hidden;
  const float* s_logp = kSmem ? reinterpret_cast<const float*>(smem + L.logp) : logp_row;
  const float* s_cdf = kSmem ? reinterpret_cast<const float*>(smem + L.cdf) : cdf_row;
  const float* s_val = kSmem ? reinterpret_cast<const float*>(smem + L.value) : value_row;
  const uint8_t* s_done = kSmem ? smem + L.done : done_tab;

  const int lane0 = blockIdx.x * kThreads;
  const int n_live = min(kThreads, N - lane0);
  if (T > 0) stage_u(s_u, u, 0, min(kTile, T), lane0, n_live, N, vec16);
  if (kSmem) {
    const size_t sa4 = 4 * (size_t)SA;
    stage_bytes(smem + L.next, reinterpret_cast<const unsigned char*>(next), sa4);
    stage_bytes(smem + L.reward, reinterpret_cast<const unsigned char*>(reward), sa4);
    stage_bytes(smem + L.hidden, reinterpret_cast<const unsigned char*>(hidden), sa4);
    stage_bytes(smem + L.logp, reinterpret_cast<const unsigned char*>(logp_row), sa4);
    stage_bytes(smem + L.cdf, reinterpret_cast<const unsigned char*>(cdf_row),
                4 * (size_t)S * C);
    stage_bytes(smem + L.value, reinterpret_cast<const unsigned char*>(value_row),
                4 * (size_t)S);
    stage_bytes(smem + L.done, done_tab, SA);
  }
  cp_async_commit();

  const int lane = lane0 + threadIdx.x;
  const bool live = lane < N;
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
  cp_async_wait_all();
  __syncthreads();

  int cur = 0;
  for (int s0 = 0; s0 < T; s0 += kTile) {
    const int steps = min(kTile, T - s0);
    if (s0 + kTile < T)  // the next tile, into the other buffer
      stage_u(s_u + (cur ^ 1) * kTile * kThreads, u, s0 + kTile, min(kTile, T - s0 - kTile),
              lane0, n_live, N, vec16);
    const float* in = s_u + cur * kTile * kThreads + threadIdx.x;
    if (live) {
      for (int k = 0; k < steps; ++k) {
        const float uu = in[k * kThreads];
        const float* cdf = s_cdf + idx * C;
        int act = 0;  // the first 7 compares unrolled: their loads issue together
#pragma unroll
        for (int c = 0; c < 7; ++c)
          if (c < C) act += uu >= rd<kSmem>(cdf, c) ? 1 : 0;
        for (int c = 7; c < C; ++c) act += uu >= rd<kSmem>(cdf, c) ? 1 : 0;
        const int j = idx * A + act;
        const int nxt = rd<kSmem>(s_next, j);
        const float r = rd<kSmem>(s_rew, j);
        const float h = rd<kSmem>(s_hid, j);
        const int t1 = t + 1;
        const bool done = rd<kSmem>(s_done, j) != 0 || t1 >= max_steps;

        // The records in the buffer's order: the int32 ones, then the floats.
        uint32_t* o = s_rec + k * kThreads + threadIdx.x;
        constexpr int R = kTile * kThreads;  // one record's tile
        o[0 * R] = (uint32_t)idx;
        o[1 * R] = (uint32_t)t;
        o[2 * R] = (uint32_t)act;
        o[3 * R] = done ? 1u : 0u;
        o[4 * R] = (uint32_t)nxt;
        o[5 * R] = __float_as_uint(rd<kSmem>(s_logp, j));
        o[6 * R] = __float_as_uint(rd<kSmem>(s_val, idx));
        o[7 * R] = __float_as_uint(r);
        o[8 * R] = __float_as_uint(h);

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
    cp_async_wait_all();  // this thread's copies of the next tile
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

// Bytes of shared memory a block takes for S states and A actions: the
// uniform and record tiles, then the tables and rows at 16-byte boundaries.
// Without smem_tables, the tiles alone. Mirrored by
// ops/ppo_collect_kernel.py::smem_bytes.
extern "C" long long ppo_collect_smem_bytes(int S, int A, int smem_tables) {
  return (long long)layout(S, A, smem_tables != 0).total;
}

// Where the tables and rows go: 1 (shared memory) if they fit one block
// beside the tiles, else 0 (device memory). Mirrored by
// ops/ppo_collect_kernel.py::placement.
extern "C" int ppo_collect_placement(int S, int A) { return layout(S, A).total <= kMaxSmem; }

// Launch on `stream`; returns cudaGetLastError() (0 on success). Indices
// must lie in [0, S); A >= 2; T >= 0, N >= 1. `out` is one buffer of
// 9·T·N + 9·N 4-byte words, laid out as ppo_stoch_collect_launch lays out
// its own (ops/ppo_collect_kernel.py::carve_outputs): the nine [T, N]
// records pre_idx, pre_t, action, done, next_idx (int32), logp, value,
// reward, hidden (float32), then the (1, N) lanes idx, t, ep_len (int32),
// ep_return, ep_hidden and the accumulators episodes, return, hidden,
// length (float32). smem_tables selects the placement of the tables and
// rows (1: shared memory, where they must fit; 0: device memory).
extern "C" int ppo_collect_launch(
    const void* next, const void* reward, const void* hidden, const void* done_tab,
    const void* logp_row, const void* cdf_row, const void* value_row, int S, int A,
    int max_steps, int reset_idx, const void* idx0, const void* t0, const void* epr0,
    const void* eph0, const void* epl0, const void* u, int T, int N, void* out,
    void* stream, int smem_tables) {
  if (N < 1 || T < 0 || A < 2 || S < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(S, A, smem_tables != 0).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = smem_tables ? ppo_collect_kernel<true> : ppo_collect_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec16 = N % 4 == 0 && (((uintptr_t)out | (uintptr_t)u) & 15) == 0;
  uint32_t* rec = (uint32_t*)out;
  const int blocks = (N + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)next, (const float*)reward, (const float*)hidden,
      (const uint8_t*)done_tab, (const float*)logp_row, (const float*)cdf_row,
      (const float*)value_row, S, A, max_steps, reset_idx, (const int32_t*)idx0,
      (const int32_t*)t0, (const float*)epr0, (const float*)eph0, (const int32_t*)epl0,
      (const float*)u, T, N, vec16 ? 1 : 0, rec, rec + (size_t)kRecords * T * N);
  return (int)cudaGetLastError();
}
