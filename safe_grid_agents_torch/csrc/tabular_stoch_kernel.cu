// Fused tabular-Q training on a stochastic compiled env: ε-greedy act ->
// env step with the stochastic mechanics -> duplicate-averaged TD over all
// N lanes, for T steps, in one thread block.
//
// Replaces safe_grid_agents_tpu/ops/tabular_stoch_kernel.py::_kernel
// (launched by tabq_stoch_run through pl.pallas_call): B2's design
// (tabular_kernel.cu: Q, the TD sums and counts in shared memory, each
// thread owning up to 4 lanes, a barrier between act and update) with B7's
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
// What bounds it on this card: every step's TD sums over all N lanes must
// land before any lane reads Q again, so the batch lives in ONE block with
// two barriers per step; device-memory traffic is the presampled streams
// the env uses (rand_a, u, plus bits and/or stumble, rand2), 12-20 bytes
// per lane-step. Like B2 it is bound by the serial step chain (barriers,
// dependent shared-memory reads, atomics on hot (s, a) cells).
//
// Numerics: round-to-nearest intrinsics everywhere, so no FMA moves a
// `u < ε` decision. Unlike B2, the TD sums are not float atomics: on these
// envs lanes in one (s, a) cell see different successors (stumble, drying,
// timeouts), so a run-dependent order of float adds changes Q in the last
// bit, and over a few hundred steps an argmax near a tie flips and the
// trajectories part (measured on the card at N = 4096, T = 256 on tomato).
// Each TD error is added as a 64-bit fixed-point integer (2^-32 units,
// rounded to nearest even); integer adds are exact in any order, so the
// kernel is deterministic and bitwise equal to the plain version, which
// sums the same integers. The sum returns to float through double, as the
// plain version converts it. Range: |TD| < 2^19 per lane at N <= 4096
// (int64 holds 2^63); this suite's TD errors stay below ~10^4.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stoch_step.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLanesPerThread = 4;   // N <= 4096
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap
constexpr float kTdScale = 4294967296.f;       // 2^32: TD fixed-point units
constexpr double kTdUnit = 1.0 / 4294967296.0;  // 2^-32

template <bool kSmemTables>
__global__ void __launch_bounds__(kMaxThreads) tabq_stoch_kernel(
    StochEnv genv, int S, float lr, float gamma, float eps0, float eps_delta,
    float anneal, const float* __restrict__ q0, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0,
    const int64_t* __restrict__ step0, const int32_t* __restrict__ rand_a,
    const float* __restrict__ u, const int32_t* __restrict__ bits,
    const int32_t* __restrict__ stumble, const int32_t* __restrict__ rand2, int T,
    int N, float* __restrict__ q_o, int32_t* __restrict__ idx_o,
    int32_t* __restrict__ t_o, float* __restrict__ epr_o, float* __restrict__ eph_o,
    int32_t* __restrict__ epl_o, int64_t* __restrict__ step_o,
    float* __restrict__ eacc_o, float* __restrict__ racc_o,
    float* __restrict__ hacc_o, float* __restrict__ lacc_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = genv.A;
  const int SA = S * A;
  unsigned long long* s_td = reinterpret_cast<unsigned long long*>(smem);
  float* s_q = reinterpret_cast<float*>(s_td + SA);
  float* s_cnt = s_q + SA;
  StochEnv env = genv;
  if (kSmemTables) env = stage_tables(genv, S, reinterpret_cast<unsigned char*>(s_cnt + SA));
  for (int c = threadIdx.x; c < SA; c += blockDim.x) {
    s_q[c] = q0[c];
    s_td[c] = 0ull;
    s_cnt[c] = 0.f;
  }
  const bool use_bits = env.mode != 0 || env.dry_mask != 0;
  const bool noise = env.drunk != nullptr;

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
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    // Linear ε anneal from the global step counter (as B2).
    const int64_t step_t = st0 + (int64_t)s * N;
    float frac = __fdiv_rn(__ll2float_rn(step_t), anneal);
    frac = fminf(fmaxf(frac, 0.f), 1.f);
    const float eps_t = __fadd_rn(eps0, __fmul_rn(frac, eps_delta));

    // Phase 1: act on the observed index, step, TD against the pre-update Q.
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int lane = threadIdx.x + j * blockDim.x;
      if (lane >= N) continue;
      const int idx = st[j].idx;
      const float* qrow = s_q + idx * A;
      int greedy = 0;  // first max: ties go to the lowest action
      float m = qrow[0];
      for (int a = 1; a < A; ++a) {
        if (qrow[a] > m) { m = qrow[a]; greedy = a; }
      }
      const size_t off = (size_t)s * N + lane;
      const int act = u[off] < eps_t ? rand_a[off] : greedy;  // the CHOSEN action
      const int b = use_bits ? bits[off] : 0;
      int sm = 0, r2 = 0;
      if (noise) {
        sm = stumble[off];
        r2 = rand2[off];
      }
      const LaneStep o = stoch_lane_step(env, st[j], act, b, sm, r2);
      const float* nrow = s_q + o.nxt * A;
      float boot = nrow[0];
      for (int a = 1; a < A; ++a) boot = fmaxf(boot, nrow[a]);
      const float target = __fadd_rn(o.reward, __fmul_rn(gamma, o.done ? 0.f : boot));
      const float td = __fsub_rn(target, qrow[act]);
      const int k = idx * A + act;
      atomicAdd(&s_td[k], (unsigned long long)__float2ll_rn(__fmul_rn(td, kTdScale)));
      atomicAdd(&s_cnt[k], 1.f);

      const float dx = o.done ? 1.f : 0.f;
      eacc[j] = __fadd_rn(eacc[j], dx);
      racc[j] = __fadd_rn(racc[j], __fmul_rn(dx, o.epr));
      hacc[j] = __fadd_rn(hacc[j], __fmul_rn(dx, o.eph));
      lacc[j] = __fadd_rn(lacc[j], __fmul_rn(dx, (float)o.epl));
    }
    __syncthreads();
    // Phase 2: duplicate-averaged update, Q += (lr * td_sum) / max(cnt, 1).
    for (int c = threadIdx.x; c < SA; c += blockDim.x) {
      const double sum = __dmul_rn(__ll2double_rn((long long)s_td[c]), kTdUnit);
      const float upd = __fdiv_rn(__fmul_rn(lr, __double2float_rn(sum)), fmaxf(s_cnt[c], 1.f));
      s_q[c] = __fadd_rn(s_q[c], upd);
      s_td[c] = 0ull;
      s_cnt[c] = 0.f;
    }
    __syncthreads();
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

}  // namespace

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
  const size_t q_bytes = (size_t)S * A * 16;
  const size_t smem =
      q_bytes + (smem_tables ? stoch_table_bytes(S, A, mode, drunk != nullptr) : 0);
  if (smem > kMaxSmem || N < 1 || N > kMaxThreads * kLanesPerThread || T < 0 ||
      mode < 0 || mode > 2 || dry_nbits < 0 || dry_nbits > 30 ||
      (mode == 2 && (cand0 == nullptr || cand1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StochEnv env{(const int32_t*)next, (const float*)reward, (const float*)hidden,
                     (const uint8_t*)done, (const int32_t*)cand0, (const int32_t*)cand1,
                     (const uint8_t*)drunk, A, max_steps, mode, r0, r1,
                     (1 << dry_nbits) - 1};
  auto kernel = smem_tables ? tabq_stoch_kernel<true> : tabq_stoch_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = N < kMaxThreads ? N : kMaxThreads;
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      env, S, lr, gamma, eps0, eps_delta, anneal, (const float*)q0, (const int32_t*)idx0,
      (const int32_t*)t0, (const float*)epr0, (const float*)eph0, (const int32_t*)epl0,
      (const int64_t*)step0, (const int32_t*)rand_a, (const float*)u,
      (const int32_t*)bits, (const int32_t*)stumble, (const int32_t*)rand2, T, N,
      (float*)q_o, (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o, (float*)eph_o,
      (int32_t*)epl_o, (int64_t*)step_o, (float*)eacc_o, (float*)racc_o,
      (float*)hacc_o, (float*)lacc_o);
  return (int)cudaGetLastError();
}
