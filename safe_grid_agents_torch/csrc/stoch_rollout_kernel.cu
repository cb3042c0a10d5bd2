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
// fit in one block's 227 KB (13 bytes per (s, a), 21 in mode 2, plus one
// byte per state for the drunk row: tomato 70 KB, friend at cap 15 182 KB),
// device memory otherwise (friend at cap 127, ~1.5 MB, stays in L2).
//
// What bounds it on this card: the device-memory traffic in the loop is the
// streams the env uses, 4 bytes per lane-step for the actions plus 4 for
// bits (coin or drying envs) and 8 for stumble and rand_a (whisky), read
// coalesced; each step waits on the previous one through dependent table
// loads, so at N = 4096 (32 blocks of 128 threads) the kernel is bound by
// that latency chain rather than by bytes. State and accumulators stay in
// registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stoch_step.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

template <bool kSmemTables>
__global__ void __launch_bounds__(kThreads) stoch_rollout_kernel(
    StochEnv genv, int S, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0,
    const int32_t* __restrict__ actions, const int32_t* __restrict__ bits,
    const int32_t* __restrict__ stumble, const int32_t* __restrict__ rand_a,
    int T, int N, int32_t* __restrict__ idx_o, int32_t* __restrict__ t_o,
    float* __restrict__ epr_o, float* __restrict__ eph_o,
    int32_t* __restrict__ epl_o, float* __restrict__ racc_o,
    float* __restrict__ eacc_o, float* __restrict__ facc_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  StochEnv env = genv;
  if (kSmemTables) {
    env = stage_tables(genv, S, smem);
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const bool use_bits = env.mode != 0 || env.dry_mask != 0;
  const bool noise = env.drunk != nullptr;
  LaneState st{idx0[lane], t0[lane], epl0[lane], epr0[lane], eph0[lane]};
  float racc = 0.f, eacc = 0.f, facc = 0.f;
  for (int s = 0; s < T; ++s) {
    const size_t off = (size_t)s * N + lane;
    const int b = use_bits ? bits[off] : 0;
    int sm = 0, ra = 0;
    if (noise) {
      sm = stumble[off];
      ra = rand_a[off];
    }
    const LaneStep o = stoch_lane_step(env, st, actions[off], b, sm, ra);
    const float dx = o.done ? 1.f : 0.f;
    racc = __fadd_rn(racc, o.reward);
    eacc = __fadd_rn(eacc, dx);
    facc = __fadd_rn(facc, __fmul_rn(dx, o.epr));
  }
  idx_o[lane] = st.idx;
  t_o[lane] = st.t;
  epr_o[lane] = st.epr;
  eph_o[lane] = st.eph;
  epl_o[lane] = st.epl;
  racc_o[lane] = racc;
  eacc_o[lane] = eacc;
  facc_o[lane] = facc;
}

template <bool kSmemTables>
int launch(const StochEnv& env, int S, size_t smem, const void* idx0, const void* t0,
           const void* epr0, const void* eph0, const void* epl0, const void* actions,
           const void* bits, const void* stumble, const void* rand_a, int T, int N,
           void* idx_o, void* t_o, void* epr_o, void* eph_o, void* epl_o,
           void* racc_o, void* eacc_o, void* facc_o, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(stoch_rollout_kernel<kSmemTables>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kThreads - 1) / kThreads;
  stoch_rollout_kernel<kSmemTables><<<blocks, kThreads, smem, stream>>>(
      env, S, (const int32_t*)idx0, (const int32_t*)t0, (const float*)epr0,
      (const float*)eph0, (const int32_t*)epl0, (const int32_t*)actions,
      (const int32_t*)bits, (const int32_t*)stumble, (const int32_t*)rand_a, T, N,
      (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o, (float*)eph_o, (int32_t*)epl_o,
      (float*)racc_o, (float*)eacc_o, (float*)facc_o);
  return (int)cudaGetLastError();
}

}  // namespace

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
  if (N < 1 || T < 0 || mode < 0 || mode > 2 || dry_nbits < 0 || dry_nbits > 30 ||
      (mode == 2 && (cand0 == nullptr || cand1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StochEnv env{(const int32_t*)next, (const float*)reward, (const float*)hidden,
                     (const uint8_t*)done, (const int32_t*)cand0, (const int32_t*)cand1,
                     (const uint8_t*)drunk, A, max_steps, mode, r0, r1,
                     (1 << dry_nbits) - 1};
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem_tables) {
    const size_t smem = stoch_table_bytes(S, A, mode, drunk != nullptr);
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    return launch<true>(env, S, smem, idx0, t0, epr0, eph0, epl0, actions, bits, stumble,
                        rand_a, T, N, idx_o, t_o, epr_o, eph_o, epl_o, racc_o, eacc_o,
                        facc_o, st);
  }
  return launch<false>(env, S, 0, idx0, t0, epr0, eph0, epl0, actions, bits, stumble,
                       rand_a, T, N, idx_o, t_o, epr_o, eph_o, epl_o, racc_o, eacc_o,
                       facc_o, st);
}
