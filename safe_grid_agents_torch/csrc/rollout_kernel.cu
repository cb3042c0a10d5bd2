// T-step rollout of a deterministic-reset compiled env, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/rollout_kernel.py::_kernel (launched by
// _run through pl.pallas_call). The TPU kernel reads the tables through a
// one-hot matmul because Mosaic rejects per-lane gathers; CUDA has no such
// limit, so here each lane reads its (idx, a) entry straight from a table in
// shared memory.
//
// What bounds it on this card: the only device-memory traffic in the loop is
// the action matrix, 4 bytes per lane and step, read once; each lane's step
// t+1 waits on step t through a dependent shared-memory load, so the kernel
// is bound by that latency chain, not by bytes. The Hopper design (B7's, in
// stoch_rollout_kernel.cu) spreads the lanes wide, keeps device memory out
// of the chain and shortens the chain itself:
//  - one warp a block, so N = 4096 runs on 128 SMs (the first design's
//    128-thread blocks put it on 32);
//  - the action stream is staged into shared memory with cp.async
//    (cp_async_stage.cuh) in tiles of kTile = 128 steps, double-buffered:
//    the next tile is issued before the current one is walked, so no action
//    load sits in a lane's chain. Deep tiles matter: with 16-step tiles a
//    step took ~104 cycles, of which ~45 went to streaming the actions; 128
//    steps cut that to ~25 (tools/ab_rollout.py --parts). A tile's steps
//    run in an unrolled body of 16 (their action reads issue ahead of the
//    chain), a partial last tile runs rolled;
//  - the prologue packs each (s, a) entry into one 16-byte word (Packed
//    below): a step makes one shared-memory load, not four, and the load
//    holds the successor's row offset in bytes with the terminal reset
//    folded in (a done entry's successor is the reset state), so the chain
//    from one load to the next is a select on the time limit alone (known a
//    step ahead) and one add: ~40 cycles a step, the floor of this design.
//    (A copy of the table for each lane in its own bank, free of the bank
//    conflicts of 32 random 16-byte gathers, was 5% faster at T = 32768 and
//    no faster at the main path's T = 4096: not kept);
//  - the raw tables are staged with 16-byte cp.async copies into scratch
//    shared memory and packed there.
// Shared memory a block: 32 KB of action tiles, 16 bytes a (s, a) packed and
// the 13-byte raw tables (shift 40 KB; sokoban, S·A = 5184, 183 KB). Any
// T >= 0 and any N >= 1 (the last block may be partial) are taken.
//
// Where the packed table lives is a template parameter (B7's rule): shared
// memory when it fits one block's 227 KB beside the action tiles, device
// memory otherwise (conveyor, S·A = 28,224: 452 KB packed; sokoban2,
// S·A = 702,464: 11.2 MB), read through the read-only path and resident in
// L2. The device-memory table is packed once by the wrapper
// (ops/rollout_kernel.py::packed_entries, the prologue's packing) and
// passed as `gpack`; the action tiles stay in shared memory, and a step is
// the same one 16-byte load, from L2 instead of shared memory.
//
// Update order per step is the reference's (rollout_kernel.py:107-122):
// done = done_tab | t+1 >= max_steps; racc += reward; eacc += done;
// facc += done * epr (epr already holds this step's reward); then the
// auto-reset selects. All values are exact and each lane's float operations
// keep that order, so outputs are bitwise equal to the plain PyTorch version
// and to the JAX kernel.
//
// SGA_STAMP (compiled only with -DSGA_TRACE): thread 0 of block 0 records
// clock64() at the start of every tile and once after the last, so the
// stamps give the cycles of a tile (tools/ab_rollout.py --stamps).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async_stage.cuh"

namespace {

using stage::kThreads;  // one warp, one block
using stage::r16;
constexpr int kTile = 128;           // steps per action tile
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap
constexpr size_t kTileBytes = 2 * 4 * kThreads * kTile;  // the two action tile buffers

#ifdef SGA_TRACE
constexpr int kStampTiles = 4096;
__device__ long long g_stamps[kStampTiles + 1];
#define SGA_STAMP(i)                                                    \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (i) <= kStampTiles)      \
      g_stamps[(i)] = clock64();                                        \
  } while (0)
#else
#define SGA_STAMP(i) \
  do {               \
  } while (0)
#endif

// One (s, a) entry: the byte offset of the successor's row in the packed
// table (succ · A · 16, where succ is the reset state for a done entry),
// the reward and hidden reward as float bits, and the done flag. Mirrored
// by ops/rollout_kernel.py::packed_entries.
struct alignas(16) Packed {
  int32_t succ;
  uint32_t reward, hidden, done;
};

// Byte offsets of the shared-memory arrays: the action tiles, the packed
// table, then the raw tables (next, reward, hidden, done) the prologue
// packs, each at a 16-byte boundary. Mirrored by
// ops/rollout_kernel.py::smem_bytes.
struct Layout {
  size_t pack, next, reward, hidden, done, total;
};

__host__ __device__ Layout layout(int S, int A) {
  const size_t SA = (size_t)S * A;
  Layout L;
  L.pack = kTileBytes;
  L.next = L.pack + 16 * SA;
  L.reward = L.next + r16(4 * SA);
  L.hidden = L.reward + r16(4 * SA);
  L.done = L.hidden + r16(4 * SA);
  L.total = L.done + r16(SA);
  return L;
}

// A step's entry at byte offset `off` of the packed table.
template <bool kSmem>
__device__ __forceinline__ uint4 entry(const unsigned char* pack, unsigned off) {
  if (kSmem) return *reinterpret_cast<const uint4*>(pack + off);
  return __ldg(reinterpret_cast<const uint4*>(pack + off));
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) rollout_kernel(
    const int32_t* __restrict__ next, const float* __restrict__ reward,
    const float* __restrict__ hidden, const uint8_t* __restrict__ done_tab, int S, int A,
    int max_steps, int reset_idx, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0,
    const uint32_t* __restrict__ actions, int T, int N, int vec16,
    int32_t* __restrict__ idx_o, int32_t* __restrict__ t_o, float* __restrict__ epr_o,
    float* __restrict__ eph_o, int32_t* __restrict__ epl_o, float* __restrict__ racc_o,
    float* __restrict__ eacc_o, float* __restrict__ facc_o,
    const unsigned char* __restrict__ gpack) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SA = S * A;
  const Layout L = layout(S, A);
  uint32_t* s_in = reinterpret_cast<uint32_t*>(smem);  // [2][kTile][lanes]
  const int lane0 = blockIdx.x * kThreads;
  const int n_live = min(kThreads, N - lane0);
  if (T > 0) stage::stream(s_in, actions, 0, min(kTile, T), lane0, n_live, N, vec16);
  if (kSmem) {
    stage::bytes(smem + L.next, next, 4 * (size_t)SA);
    stage::bytes(smem + L.reward, reward, 4 * (size_t)SA);
    stage::bytes(smem + L.hidden, hidden, 4 * (size_t)SA);
    stage::bytes(smem + L.done, done_tab, SA);
  }
  stage::commit();

  const int lane = lane0 + threadIdx.x;
  const bool live = lane < N;
  const int row = 16 * A;  // bytes of one state's row in the packed table
  int idx = 0, t = 0, epl = 0;
  float epr = 0.f, eph = 0.f;
  if (live) {
    idx = idx0[lane];
    t = t0[lane];
    epl = epl0[lane];
    epr = epr0[lane];
    eph = eph0[lane];
  }
  float racc = 0.f, eacc = 0.f, facc = 0.f;
  stage::wait_all();
  __syncthreads();
  // The prologue's packing, from the staged raw tables.
  if (kSmem) {
    const int32_t* s_next = reinterpret_cast<const int32_t*>(smem + L.next);
    const uint32_t* s_rew = reinterpret_cast<const uint32_t*>(smem + L.reward);
    const uint32_t* s_hid = reinterpret_cast<const uint32_t*>(smem + L.hidden);
    const uint8_t* s_done = smem + L.done;
    Packed* pack = reinterpret_cast<Packed*>(smem + L.pack);
    for (int c = threadIdx.x; c < SA; c += kThreads) {
      const uint32_t d = s_done[c] != 0 ? 1u : 0u;
      pack[c] = Packed{(d ? reset_idx : s_next[c]) * row, s_rew[c], s_hid[c], d};
    }
    __syncthreads();
  }

  // A lane's position is the byte offset of its state's row in the packed
  // table; a step's load adds the action's offset in the row to it.
  const unsigned char* s_pack = kSmem ? smem + L.pack : gpack;
  const int reset_row = reset_idx * row;
  int at = idx * row;
  int cur = 0, tile = 0;
  for (int s0 = 0; s0 < T; s0 += kTile, ++tile) {
    SGA_STAMP(tile);
    const int steps = min(kTile, T - s0);
    if (s0 + kTile < T) {  // the next tile, into the other buffer
      stage::stream(s_in + (cur ^ 1) * kTile * kThreads, actions, s0 + kTile,
                    min(kTile, T - s0 - kTile), lane0, n_live, N, vec16);
      stage::commit();
    }
    const uint32_t* in = s_in + cur * kTile * kThreads + threadIdx.x;
    if (live) {
      auto step = [&](const int k) {
        const uint4 e = entry<kSmem>(s_pack, 16u * in[k * kThreads] + at);
        const float r = __uint_as_float(e.y);
        const int t1 = t + 1;
        const bool timeout = t1 >= max_steps;
        const bool done = e.w != 0u || timeout;
        const float dx = done ? 1.f : 0.f;
        epr = __fadd_rn(epr, r);
        eph = __fadd_rn(eph, __uint_as_float(e.z));
        epl += 1;
        racc = __fadd_rn(racc, r);
        eacc = __fadd_rn(eacc, dx);
        facc = __fadd_rn(facc, __fmul_rn(dx, epr));
        at = timeout ? reset_row : (int)e.x;  // a done entry's successor is the reset
        t = done ? 0 : t1;
        epr = done ? 0.f : epr;
        eph = done ? 0.f : eph;
        epl = done ? 0 : epl;
      };
      if (steps == kTile) {
#pragma unroll 16
        for (int k = 0; k < kTile; ++k) step(k);
      } else {
        for (int k = 0; k < steps; ++k) step(k);
      }
    }
    stage::wait_all();  // this thread's copies of the next tile
    __syncthreads();      // ... visible to the block; this buffer free again
    cur ^= 1;
  }
  SGA_STAMP(tile);
  if (!live) return;
  idx_o[lane] = at / row;
  t_o[lane] = t;
  epr_o[lane] = epr;
  eph_o[lane] = eph;
  epl_o[lane] = epl;
  racc_o[lane] = racc;
  eacc_o[lane] = eacc;
  facc_o[lane] = facc;
}

}  // namespace

#ifdef SGA_TRACE
// Copies the first n tile stamps of block 0 to `host`.
extern "C" int rollout_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * sizeof(long long));
}
#endif

// Bytes of shared memory a block takes for S states and A actions: with
// smem_tables, the action tiles, the packed table and the raw tables;
// without, the action tiles alone. Mirrored by
// ops/rollout_kernel.py::smem_bytes.
extern "C" long long rollout_smem_bytes(int S, int A, int smem_tables) {
  return smem_tables ? (long long)layout(S, A).total : (long long)kTileBytes;
}

// Where the packed table goes for S states and A actions: 1 (shared
// memory) if the block's layout fits, else 0 (device memory). Mirrored by
// ops/rollout_kernel.py::placement.
extern "C" int rollout_placement(int S, int A) { return layout(S, A).total <= kMaxSmem; }

// Launch on `stream`; returns cudaGetLastError() (0 on success). Actions
// must lie in [0, A) and indices in [0, S): the tables are read unchecked.
// `gpack` null: the tables are staged and packed into shared memory (they
// must fit); else it is the [S·A] 16-byte packed table in device memory
// (16-byte aligned) and the raw tables are not read.
extern "C" int rollout_launch(
    const void* next, const void* reward, const void* hidden,
    const void* done_tab, int S, int A, int max_steps, int reset_idx,
    const void* idx0, const void* t0, const void* epr0, const void* eph0,
    const void* epl0, const void* actions, int T, int N,
    void* idx_o, void* t_o, void* epr_o, void* eph_o, void* epl_o,
    void* racc_o, void* eacc_o, void* facc_o, void* stream, const void* gpack) {
  if (S < 1 || A < 1 || N < 1 || T < 0) return (int)cudaErrorInvalidValue;
  const bool smem_tables = gpack == nullptr;
  const size_t total = smem_tables ? layout(S, A).total : kTileBytes;
  // The packed row offsets are int32 byte offsets.
  if (total > kMaxSmem || 16 * (size_t)S * A > 0x7fffffff || ((uintptr_t)gpack & 15) != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = smem_tables ? rollout_kernel<true> : rollout_kernel<false>;
  if (total > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)total);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec16 = N % 4 == 0 && ((uintptr_t)actions & 15) == 0;
  const int blocks = (N + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, total, (cudaStream_t)stream>>>(
      (const int32_t*)next, (const float*)reward, (const float*)hidden,
      (const uint8_t*)done_tab, S, A, max_steps, reset_idx,
      (const int32_t*)idx0, (const int32_t*)t0, (const float*)epr0,
      (const float*)eph0, (const int32_t*)epl0, (const uint32_t*)actions, T, N, vec16 ? 1 : 0,
      (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o, (float*)eph_o,
      (int32_t*)epl_o, (float*)racc_o, (float*)eacc_o, (float*)facc_o,
      (const unsigned char*)gpack);
  return (int)cudaGetLastError();
}
