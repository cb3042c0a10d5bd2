// DQN collect on a stochastic compiled env: ε-greedy act from a frozen greedy
// row -> env step with the stochastic mechanics -> replay record, for T
// steps, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/dqn_stoch_kernel.py::_kernel (launched
// by dqn_stoch_collect_run through pl.pallas_call): B3 (dqn_kernel.cu) with
// B7's per-lane step from stoch_step.cuh — coin resets (mode 1), carried
// resets (mode 2), whisky's stumble, tomato's drying. Two distinctions are
// kept exact, as in B8:
//   * the greedy action is read at the index the agent observed (pre-dry),
//     and the record stores that index;
//   * the record stores the CHOSEN action (ε-greedy); the EFFECTIVE one
//     (whisky's stumble) steps the env at the DRIED index.
// The TPU kernel reads the tables and the greedy row through one-hot
// matmuls against a hi/lo bf16 payload, because Mosaic rejects per-lane
// gathers; here each lane reads its own entries.
//
// What bounds it on this card: device-memory traffic is the [T, N] draw
// streams the env reads (u and rand_a: 8 bytes per lane-step; bits: 4 more
// in coin or drying envs; stumble and rand2: 8 more in whisky) and the six
// [T, N] records out (24 bytes), so it is bytes-bound on paper; in fact one
// lane's steps are a dependent chain (greedy read -> table reads -> next
// state), and at the trainer's width (N = 128, T = 32) the launch dominates.
// The Hopper design is B3's, with B7's mechanics and placement:
//  - one warp a block, so N = 128 runs on 4 SMs and N = 4096 on 128;
//  - the streams the env reads are staged into shared memory with cp.async
//    (cp_async_stage.cuh), double-buffered: the next tile is issued before
//    the current one is walked, so no draw load sits in a lane's chain. The
//    tile depth is the largest of 128, 64, 32 and 16 steps that fits beside
//    the rest (streaming a step's draws costs less with deeper tiles: B1's
//    ~45 cycles a step at 16 steps, ~25 at 128);
//  - ε depends on the step alone, so it is computed once a tile for all its
//    steps (a step's share of the warp's work), not once a step by each lane;
//  - placement (Layout, picked per launch from the shapes): the tables and
//    the int32 greedy row in shared memory, staged with cp.async, where they
//    fit with 16-step tiles (absent, interrupt, whisky, tomato, friend at cap
//    15); else both in device memory (friend at cap 127), the tables read by
//    global_lane_step with its loads hoisted;
//  - the six records: with the tables in shared memory, stored by each lane
//    at each step (a warp's 32 words are one coalesced 128-byte row); with
//    the tables in device memory, written to a record tile in shared memory
//    and stored after the tile in bulk, 16 bytes a store where the rows
//    allow it. Each is the faster of the two at its placement (PERF.md,
//    tools/b9_variants.py); without the tile, the tables in shared memory
//    leave deeper draw tiles.
// Any T >= 0 (the last tile may be partial) and any N >= 1 (the last block
// may be partial) are taken.
//
// Numerics: ε uses round-to-nearest intrinsics (as B3) so no FMA contraction
// moves a `u < ε` decision; the step counter is int64; the episode sums run
// in step order with round-to-nearest adds. Every output is bitwise the
// plain PyTorch version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async_stage.cuh"
#include "stoch_step.cuh"

namespace {

using stage::kThreads;  // one warp, one block
using stage::r16;
constexpr int kRecords = 6;
constexpr int kMaxTile = 128, kMinTile = 16;  // tile depths: 128, 64, 32, 16 steps
constexpr size_t kMaxSmem = 232448;           // 227 KB: a block's dynamic shared memory cap
// The output buffer: the int64 step in its first 16 bytes, then the six
// [T, N] records, then the (1, N) lanes, all 4-byte words (B3's).
constexpr size_t kHeadWords = 4;

// Where the tables and the greedy row live.
enum Place { kShared = 0, kGlobal = 1 };

// The streams the env reads (u and rand_a always; bits where there is a
// coin or drying; stumble and rand2 where there is noise), else null, and
// their count: a tile holds them in slots 0.. in that order.
struct Streams {
  const uint32_t *u, *rand_a, *bits, *stumble, *rand2;
  int count;
};

// The launch's placement, tile depth and shared-memory byte offsets: the
// draw tiles (two buffers), the record tile (where the tables are in device
// memory), the tile's ε values, then, where they are staged, next, reward,
// hidden, cand0 and cand1 (mode 2), done and drunk (noise), and the int32
// greedy row, each at a 16-byte boundary. Mirrored by
// ops/dqn_stoch_kernel.py::layout.
struct Layout {
  int place, tile;
  size_t rec, eps, next, reward, hidden, cand0, cand1, done, drunk, greedy, total;
};

Layout layout_at(int S, int A, int mode, bool noise, int n_streams, int place, int tile) {
  const size_t SA = (size_t)S * A;
  const size_t slot = 4 * (size_t)kThreads * tile;  // one stream's or record's tile
  Layout L;
  L.place = place;
  L.tile = tile;
  const bool record_tile = place == kGlobal;
  L.rec = 2 * n_streams * slot;
  L.eps = L.rec + (record_tile ? kRecords * slot : 0);
  size_t at = L.eps + 4 * (size_t)tile;
  L.next = L.reward = L.hidden = L.cand0 = L.cand1 = L.done = L.drunk = L.greedy = at;
  if (place == kShared) {
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
    L.greedy = at;
    at += r16(4 * (size_t)S);
  }
  L.total = at;
  return L;
}

// The first placement that fits (tables and greedy row, or neither), with
// the deepest tile that fits there.
Layout layout(int S, int A, int mode, bool noise, int n_streams) {
  Layout L{};
  for (int place = kShared; place <= kGlobal; ++place) {
    for (int tile = kMaxTile; tile >= kMinTile; tile /= 2) {
      L = layout_at(S, A, mode, noise, n_streams, place, tile);
      if (L.total <= kMaxSmem) return L;
    }
  }
  return L;  // not reached: kGlobal at 16 steps takes at most 33 KB (5 streams)
}

int stream_count(int mode, int dry_nbits, bool noise) {
  return 2 + (mode != 0 || dry_nbits != 0 ? 1 : 0) + (noise ? 2 : 0);
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

// Stages every read stream's tile of `steps` steps from step s0 into dst
// ([slot][step][lane], `tile` steps a slot) and commits the copies as one
// group.
__device__ __forceinline__ void stage_tile(uint32_t* dst, const Streams& st, int tile, int s0,
                                           int steps, int lane0, int n_live, int N,
                                           bool vec16) {
  const int slot = tile * kThreads;
  int i = 0;
  stage::stream(dst + slot * i++, st.u, s0, steps, lane0, n_live, N, vec16);
  stage::stream(dst + slot * i++, st.rand_a, s0, steps, lane0, n_live, N, vec16);
  if (st.bits != nullptr)
    stage::stream(dst + slot * i++, st.bits, s0, steps, lane0, n_live, N, vec16);
  if (st.stumble != nullptr) {
    stage::stream(dst + slot * i++, st.stumble, s0, steps, lane0, n_live, N, vec16);
    stage::stream(dst + slot * i, st.rand2, s0, steps, lane0, n_live, N, vec16);
  }
  stage::commit();
}

// ε of the steps [s0, s0 + steps) into eps: the linear anneal from the
// global step counter (dqn_stoch_kernel.py:98-100), the same for every lane.
__device__ __forceinline__ void tile_eps(float* eps, int64_t st0, int s0, int steps, int N,
                                         float eps0, float eps_delta, float anneal) {
  for (int k = threadIdx.x; k < steps; k += kThreads) {
    const int64_t step_t = st0 + (int64_t)(s0 + k) * N;
    float frac = __fdiv_rn(__ll2float_rn(step_t), anneal);
    frac = fminf(fmaxf(frac, 0.f), 1.f);
    eps[k] = __fadd_rn(eps0, __fmul_rn(frac, eps_delta));
  }
}

// Stores the `steps` rows of each record of the record tile s_rec ([6]
// [tile][lanes], `slot` words a record) to rows s0.. of the [6][T, N]
// records: with vec16 16 bytes a store, 8 stores a full row of 32 lanes, 4
// rows at a time.
__device__ __forceinline__ void store_records(uint32_t* rec, const uint32_t* s_rec, int slot,
                                              int s0, int steps, int T, int N, int lane0,
                                              int n_live, bool vec16) {
  if (vec16) {
    const int q = 4 * (threadIdx.x % (kThreads / 4));
    if (q < n_live)
      for (int r = 0; r < kRecords; ++r)
        for (int row = threadIdx.x / (kThreads / 4); row < steps; row += 4)
          *reinterpret_cast<uint4*>(rec + (r * (size_t)T + s0 + row) * N + lane0 + q) =
              *reinterpret_cast<const uint4*>(s_rec + r * slot + row * kThreads + q);
  } else if ((int)threadIdx.x < n_live) {
    for (int r = 0; r < kRecords; ++r)
      for (int row = 0; row < steps; ++row)
        rec[(r * (size_t)T + s0 + row) * N + lane0 + threadIdx.x] =
            s_rec[r * slot + row * kThreads + threadIdx.x];
  }
}

template <int kPlace>
__global__ void __launch_bounds__(kThreads) dqn_stoch_kernel(
    StochEnv genv, int S, Layout L, const int32_t* __restrict__ greedy_row, float eps0,
    float eps_delta, float anneal, int use_hidden, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0,
    const int64_t* __restrict__ step0, Streams streams, int vec16, int T, int N,
    int64_t* __restrict__ step_o, uint32_t* __restrict__ rec, uint32_t* __restrict__ lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kRecordTile = kPlace == kGlobal;  // Layout
  const int tile = L.tile;
  const int slot = tile * kThreads;  // words of one stream's or record's tile
  const size_t TN = (size_t)T * N;   // words of one record
  const int buf_words = streams.count * slot;
  uint32_t* s_in = reinterpret_cast<uint32_t*>(smem);           // [2][streams][tile][lanes]
  uint32_t* s_rec = reinterpret_cast<uint32_t*>(smem + L.rec);  // [6][tile][lanes]
  float* s_eps = reinterpret_cast<float*>(smem + L.eps);        // [tile]
  const int lane0 = blockIdx.x * kThreads;
  const int n_live = min(kThreads, N - lane0);
  if (T > 0) stage_tile(s_in, streams, tile, 0, min(tile, T), lane0, n_live, N, vec16);
  StochEnv env = genv;
  const int32_t* greedy = greedy_row;
  if (kPlace == kShared) {
    env = stage_env(genv, S, L, smem);
    stage::bytes(smem + L.greedy, greedy_row, 4 * (size_t)S);
    greedy = reinterpret_cast<const int32_t*>(smem + L.greedy);
  }
  stage::commit();

  const int lane = lane0 + threadIdx.x;
  const bool live = lane < N;
  const bool use_bits = streams.bits != nullptr;
  const bool noise = streams.stumble != nullptr;
  const int i_stumble = use_bits ? 3 : 2;
  const int64_t st0 = *step0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *step_o = st0 + (int64_t)T * N;
  LaneState st{0, 0, 0, 0.f, 0.f};
  if (live) st = LaneState{idx0[lane], t0[lane], epl0[lane], epr0[lane], eph0[lane]};
  float eacc = 0.f, racc = 0.f, hacc = 0.f, lacc = 0.f;
  if (T > 0) tile_eps(s_eps, st0, 0, min(tile, T), N, eps0, eps_delta, anneal);
  stage::wait_all();
  __syncthreads();

  int cur = 0;
  for (int s0 = 0; s0 < T; s0 += tile) {
    const int steps = min(tile, T - s0);
    if (s0 + tile < T)  // the next tile, into the other buffer
      stage_tile(s_in + (cur ^ 1) * buf_words, streams, tile, s0 + tile,
                 min(tile, T - s0 - tile), lane0, n_live, N, vec16);
    const uint32_t* in = s_in + cur * buf_words + threadIdx.x;
    if (live) {
      auto step = [&](const int k) {
        const uint32_t* d = in + k * kThreads;
        const float uu = __uint_as_float(d[0]);
        const int ra = (int)d[slot];
        const int b = use_bits ? (int)d[2 * slot] : 0;
        int sm = 0, r2 = 0;
        if (noise) {
          sm = (int)d[i_stumble * slot];
          r2 = (int)d[(i_stumble + 1) * slot];
        }
        const int pidx = st.idx, pt = st.t;
        const int act = uu < s_eps[k] ? ra : greedy[pidx];  // the CHOSEN action
        const LaneStep o = kPlace == kShared ? stoch_lane_step(env, st, act, b, sm, r2)
                                             : global_lane_step(env, st, act, b, sm, r2);
        // The records in the buffer's order: the int32 ones, then reward.
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

        const float dx = o.done ? 1.f : 0.f;
        eacc = __fadd_rn(eacc, dx);
        racc = __fadd_rn(racc, __fmul_rn(dx, o.epr));
        hacc = __fadd_rn(hacc, __fmul_rn(dx, o.eph));
        lacc = __fadd_rn(lacc, __fmul_rn(dx, (float)o.epl));
      };
      // Runs of 16 steps are unrolled, so the compiler reads their draws
      // ahead of the chain; a partial run at the end runs rolled.
      int k = 0;
      for (; k + 16 <= steps; k += 16) {
#pragma unroll
        for (int j = 0; j < 16; ++j) step(k + j);
      }
      for (; k < steps; ++k) step(k);
    }
    __syncthreads();  // the record tile is complete, the ε tile read
    if (kRecordTile) store_records(rec, s_rec, slot, s0, steps, T, N, lane0, n_live, vec16);
    if (s0 + tile < T)
      tile_eps(s_eps, st0, s0 + tile, min(tile, T - s0 - tile), N, eps0, eps_delta, anneal);
    stage::wait_all();  // this thread's copies of the next tile
    __syncthreads();      // ... visible to the block; the record and ε tiles free again
    cur ^= 1;
  }
  if (!live) return;
  // The lanes: idx, t, ep_len (int32), then ep_return, ep_hidden and the
  // four accumulators (float32).
  lanes[lane] = (uint32_t)st.idx;
  lanes[N + lane] = (uint32_t)st.t;
  lanes[2 * N + lane] = (uint32_t)st.epl;
  lanes[3 * N + lane] = __float_as_uint(st.epr);
  lanes[4 * N + lane] = __float_as_uint(st.eph);
  lanes[5 * N + lane] = __float_as_uint(eacc);
  lanes[6 * N + lane] = __float_as_uint(racc);
  lanes[7 * N + lane] = __float_as_uint(hacc);
  lanes[8 * N + lane] = __float_as_uint(lacc);
}

}  // namespace

// The launch's placement (0: tables and greedy row in shared memory, 1:
// both in device memory), tile depth in steps and bytes of shared
// memory a block, into out[0..2]. Mirrored by ops/dqn_stoch_kernel.py::layout.
extern "C" void dqn_stoch_collect_geometry(int S, int A, int mode, int dry_nbits, int noise,
                                           long long* out) {
  const Layout L = layout(S, A, mode, noise != 0, stream_count(mode, dry_nbits, noise != 0));
  out[0] = L.place;
  out[1] = L.tile;
  out[2] = (long long)L.total;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). cand0/cand1
// are read in mode 2 only; drunk may be null (no noise); bits is read with a
// coin or drying, stumble and rand2 with noise. The greedy row and the
// actions in rand_a/rand2 must lie in [0, A), indices in [0, S): tables are
// read unchecked. T >= 0, N >= 1. `out` (16-byte aligned) is one buffer of
// 4 + 6·T·N + 9·N 4-byte words laid out as dqn_collect_launch's
// (dqn_kernel.cu): the int64 step, the six [T, N] records pre_idx, pre_t,
// action, next_idx, done (int32), reward (float32), then the (1, N) lanes
// idx, t, ep_len (int32), ep_return, ep_hidden and the accumulators
// episodes, return, hidden, length (float32). Mirrored by
// ops/dqn_kernel.py::carve_outputs.
extern "C" int dqn_stoch_collect_launch(
    const void* next, const void* reward, const void* hidden, const void* done,
    const void* cand0, const void* cand1, const void* drunk, int S, int A, int max_steps,
    int mode, int r0, int r1, int dry_nbits, const void* greedy_row, float eps0,
    float eps_delta, float anneal, int use_hidden, const void* idx0, const void* t0,
    const void* epr0, const void* eph0, const void* epl0, const void* step0,
    const void* rand_a, const void* u, const void* bits, const void* stumble,
    const void* rand2, int T, int N, void* out, void* stream) {
  if (N < 1 || T < 0 || S < 1 || A < 1 || A > 255 || mode < 0 || mode > 2 || dry_nbits < 0 ||
      dry_nbits > 30 || (mode == 2 && (cand0 == nullptr || cand1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StochEnv env{(const int32_t*)next, (const float*)reward, (const float*)hidden,
                     (const uint8_t*)done, (const int32_t*)cand0, (const int32_t*)cand1,
                     (const uint8_t*)drunk, A, max_steps, mode, r0, r1,
                     (1 << dry_nbits) - 1};
  const bool use_bits = mode != 0 || dry_nbits != 0;
  const bool noise = drunk != nullptr;
  const Streams st{(const uint32_t*)u, (const uint32_t*)rand_a,
                   use_bits ? (const uint32_t*)bits : nullptr,
                   noise ? (const uint32_t*)stumble : nullptr,
                   noise ? (const uint32_t*)rand2 : nullptr,
                   stream_count(mode, dry_nbits, noise)};
  const Layout L = layout(S, A, mode, noise, st.count);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  uint32_t* rec = (uint32_t*)out + kHeadWords;
  const uintptr_t align = (uintptr_t)rec | (uintptr_t)st.u | (uintptr_t)st.rand_a |
                          (uintptr_t)st.bits | (uintptr_t)st.stumble | (uintptr_t)st.rand2;
  const bool vec16 = N % 4 == 0 && (align & 15) == 0;
  auto kernel = L.place == kShared ? dqn_stoch_kernel<kShared> : dqn_stoch_kernel<kGlobal>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, L.total, (cudaStream_t)stream>>>(
      env, S, L, (const int32_t*)greedy_row, eps0, eps_delta, anneal, use_hidden,
      (const int32_t*)idx0, (const int32_t*)t0, (const float*)epr0, (const float*)eph0,
      (const int32_t*)epl0, (const int64_t*)step0, st, vec16 ? 1 : 0, T, N, (int64_t*)out, rec,
      rec + (size_t)kRecords * T * N);
  return (int)cudaGetLastError();
}
