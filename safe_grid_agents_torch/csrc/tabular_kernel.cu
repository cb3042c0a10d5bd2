// Fused tabular-Q training: ε-greedy act -> env step -> duplicate-averaged
// TD over all N lanes, for T steps, in one thread block.
//
// Replaces safe_grid_agents_tpu/ops/tabular_kernel.py::_kernel (launched by
// tabq_run through pl.pallas_call). The TPU kernel reads Q rows and the env
// tables through one-hot matmuls and sums the TD errors with a
// lane-contraction matmul, all to avoid per-lane gathers that Mosaic
// rejects. Here Q [S, A], the TD sums and counts [S, A] and the env tables
// (13 bytes per (s, a)) sit in shared memory and each lane reads and
// scatters its own entries.
//
// What bounds it on this card: every step's TD sums over ALL N lanes must
// land before any lane reads Q again (the trainers' batched TD against the
// pre-update Q), so the whole batch lives in ONE thread block (1 of 132 SMs)
// with two block barriers per step. Device-memory traffic is only the
// presampled draws, 8 bytes per lane and step; the kernel is bound by the
// serial step chain (barriers, dependent shared-memory reads, shared-memory
// atomics on the few hot (s, a) cells), not by bytes or operations. The
// design keeps lane state in registers (each thread owns up to 4 lanes) and
// keeps Q resident across all T steps; spreading the step over more SMs is
// later work.
//
// Numerics: every float op of ε, the TD target, td and the Q update uses
// the round-to-nearest intrinsics, so no FMA contraction moves a `u < ε`
// decision or a td by an ulp away from the plain version. The update keeps
// the reference's association (lr * td_sum) / max(cnt, 1). Shared-memory
// float atomics add in a run-dependent order, so Q agrees with the plain
// version to rounding, not bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLanesPerThread = 4;   // N <= 4096
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

__global__ void __launch_bounds__(kMaxThreads) tabq_kernel(
    const int32_t* __restrict__ next, const float* __restrict__ reward,
    const float* __restrict__ hidden, const uint8_t* __restrict__ done_tab,
    int SA, int A, int max_steps, int reset_idx,
    float lr, float gamma, float eps0, float eps_delta, float anneal,
    const float* __restrict__ q0, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0,
    const int64_t* __restrict__ step0, const int32_t* __restrict__ rand_a,
    const float* __restrict__ u, int T, int N,
    float* __restrict__ q_o, int32_t* __restrict__ idx_o,
    int32_t* __restrict__ t_o, float* __restrict__ epr_o,
    float* __restrict__ eph_o, int32_t* __restrict__ epl_o,
    int64_t* __restrict__ step_o, float* __restrict__ eacc_o,
    float* __restrict__ racc_o, float* __restrict__ hacc_o,
    float* __restrict__ lacc_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_td = s_q + SA;
  float* s_cnt = s_td + SA;
  int32_t* s_next = reinterpret_cast<int32_t*>(s_cnt + SA);
  float* s_rew = reinterpret_cast<float*>(s_next + SA);
  float* s_hid = s_rew + SA;
  uint8_t* s_done = reinterpret_cast<uint8_t*>(s_hid + SA);
  for (int c = threadIdx.x; c < SA; c += blockDim.x) {
    s_q[c] = q0[c];
    s_td[c] = 0.f;
    s_cnt[c] = 0.f;
    s_next[c] = next[c];
    s_rew[c] = reward[c];
    s_hid[c] = hidden[c];
    s_done[c] = done_tab[c];
  }

  int idx[kLanesPerThread], t[kLanesPerThread], epl[kLanesPerThread];
  float epr[kLanesPerThread], eph[kLanesPerThread];
  float eacc[kLanesPerThread], racc[kLanesPerThread];
  float hacc[kLanesPerThread], lacc[kLanesPerThread];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const int lane = threadIdx.x + j * blockDim.x;
    const bool live = lane < N;
    idx[j] = live ? idx0[lane] : 0;
    t[j] = live ? t0[lane] : 0;
    epl[j] = live ? epl0[lane] : 0;
    epr[j] = live ? epr0[lane] : 0.f;
    eph[j] = live ? eph0[lane] : 0.f;
    eacc[j] = racc[j] = hacc[j] = lacc[j] = 0.f;
  }
  const int64_t st0 = *step0;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    // Linear ε anneal from the global step counter (tabular_kernel.py:100-106).
    const int64_t step_t = st0 + (int64_t)s * N;
    float frac = __fdiv_rn(__ll2float_rn(step_t), anneal);
    frac = fminf(fmaxf(frac, 0.f), 1.f);
    const float eps_t = __fadd_rn(eps0, __fmul_rn(frac, eps_delta));

    // Phase 1: act, step, TD against the pre-update Q, episode accounting.
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int lane = threadIdx.x + j * blockDim.x;
      if (lane >= N) continue;
      const float* qrow = s_q + idx[j] * A;
      int greedy = 0;  // first max: ties go to the lowest action
      float m = qrow[0];
      for (int a = 1; a < A; ++a) {
        if (qrow[a] > m) { m = qrow[a]; greedy = a; }
      }
      const size_t off = (size_t)s * N + lane;
      const int act = u[off] < eps_t ? rand_a[off] : greedy;
      const int k = idx[j] * A + act;
      const int nxt = s_next[k];
      const float r = s_rew[k];
      const int t1 = t[j] + 1;
      const bool done = s_done[k] != 0 || t1 >= max_steps;
      const float* nrow = s_q + nxt * A;
      float boot = nrow[0];
      for (int a = 1; a < A; ++a) boot = fmaxf(boot, nrow[a]);
      const float target = __fadd_rn(r, __fmul_rn(gamma, done ? 0.f : boot));
      const float td = __fsub_rn(target, qrow[act]);
      atomicAdd(&s_td[k], td);
      atomicAdd(&s_cnt[k], 1.f);

      const float dx = done ? 1.f : 0.f;
      epr[j] = __fadd_rn(epr[j], r);
      eph[j] = __fadd_rn(eph[j], s_hid[k]);
      epl[j] += 1;
      eacc[j] = __fadd_rn(eacc[j], dx);
      racc[j] = __fadd_rn(racc[j], __fmul_rn(dx, epr[j]));
      hacc[j] = __fadd_rn(hacc[j], __fmul_rn(dx, eph[j]));
      lacc[j] = __fadd_rn(lacc[j], __fmul_rn(dx, (float)epl[j]));
      idx[j] = done ? reset_idx : nxt;
      t[j] = done ? 0 : t1;
      epr[j] = done ? 0.f : epr[j];
      eph[j] = done ? 0.f : eph[j];
      epl[j] = done ? 0 : epl[j];
    }
    __syncthreads();
    // Phase 2: duplicate-averaged update, Q += (lr * td_sum) / max(cnt, 1).
    for (int c = threadIdx.x; c < SA; c += blockDim.x) {
      const float upd = __fdiv_rn(__fmul_rn(lr, s_td[c]), fmaxf(s_cnt[c], 1.f));
      s_q[c] = __fadd_rn(s_q[c], upd);
      s_td[c] = 0.f;
      s_cnt[c] = 0.f;
    }
    __syncthreads();
  }

  for (int c = threadIdx.x; c < SA; c += blockDim.x) q_o[c] = s_q[c];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
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

// Launch on `stream`; returns cudaGetLastError() (0 on success). Needs
// 1 <= N <= 4096; actions drawn in rand_a and all indices must be in range.
extern "C" int tabq_launch(
    const void* next, const void* reward, const void* hidden,
    const void* done_tab, int S, int A, int max_steps, int reset_idx,
    float lr, float gamma, float eps0, float eps_delta, float anneal,
    const void* q0, const void* idx0, const void* t0, const void* epr0,
    const void* eph0, const void* epl0, const void* step0,
    const void* rand_a, const void* u, int T, int N,
    void* q_o, void* idx_o, void* t_o, void* epr_o, void* eph_o, void* epl_o,
    void* step_o, void* eacc_o, void* racc_o, void* hacc_o, void* lacc_o,
    void* stream) {
  const int SA = S * A;
  const size_t smem = (size_t)SA * 25;
  if (smem > kMaxSmem || N < 1 || N > kMaxThreads * kLanesPerThread || T < 0)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tabq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = N < kMaxThreads ? N : kMaxThreads;
  tabq_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)next, (const float*)reward, (const float*)hidden,
      (const uint8_t*)done_tab, SA, A, max_steps, reset_idx,
      lr, gamma, eps0, eps_delta, anneal,
      (const float*)q0, (const int32_t*)idx0, (const int32_t*)t0,
      (const float*)epr0, (const float*)eph0, (const int32_t*)epl0,
      (const int64_t*)step0, (const int32_t*)rand_a, (const float*)u, T, N,
      (float*)q_o, (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o,
      (float*)eph_o, (int32_t*)epl_o, (int64_t*)step_o, (float*)eacc_o,
      (float*)racc_o, (float*)hacc_o, (float*)lacc_o);
  return (int)cudaGetLastError();
}
