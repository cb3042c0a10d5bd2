// PPO collect on a stochastic compiled env: inverse-CDF act from frozen
// policy rows -> env step with the stochastic mechanics -> rollout records,
// for T steps, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/ppo_stoch_collect_kernel.py::_kernel
// (launched by ppo_stoch_collect_run through pl.pallas_call): B5's design
// (ppo_collect_kernel.cu: the lane's state and episode sums in registers,
// the whole T loop inside the thread) with B7's per-lane step from
// stoch_step.cuh — coin resets (mode 1), carried resets (mode 2), whisky's
// stumble, tomato's drying. The policy rows (logp, cdf, value) are read at
// the index the agent observed (pre-dry); the record stores the CHOSEN
// action and its logp; the EFFECTIVE action (whisky's stumble) steps the
// env at the DRIED index. The TPU kernel reads tables and rows through f32
// one-hot matmuls against a payload, because Mosaic rejects per-lane
// gathers; here each lane reads its own entries.
//
// Where the policy rows (4·S·2A bytes: 43 KB for tomato, 571 KB for friend
// at cap 127) and the tables live is a template parameter: both in shared
// memory when they fit in one block's 227 KB, both in device memory
// otherwise (read through L1/L2).
//
// What bounds it on this card: device-memory traffic is the four [T, N]
// draw streams in (u, bits, stumble, rand_a: up to 16 bytes per lane-step;
// streams an env does not use are not read) and the nine [T, N] record
// streams out (36 bytes), all coalesced. On paper that is bytes-bound; at
// the trainer's width (N = 1024, 8 blocks on 8 of 132 SMs) it is bound by
// the dependent chain of one lane's steps (uniform load -> cdf compare ->
// table read -> next state).
//
// Numerics: the action is Σ_{k<A-1} (u >= cdf[idx, k]); every recorded
// float is a gather of a precomputed row or table entry, and the episode
// sums run in step order with round-to-nearest adds, so every output is
// bitwise the plain PyTorch version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stoch_step.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) ppo_stoch_collect_kernel(
    StochEnv genv, int S, const float* __restrict__ logp_row,
    const float* __restrict__ cdf_row, const float* __restrict__ value_row,
    const int32_t* __restrict__ idx0, const int32_t* __restrict__ t0,
    const float* __restrict__ epr0, const float* __restrict__ eph0,
    const int32_t* __restrict__ epl0, const float* __restrict__ u,
    const int32_t* __restrict__ bits, const int32_t* __restrict__ stumble,
    const int32_t* __restrict__ rand_a, int T, int N, int32_t* __restrict__ idx_o,
    int32_t* __restrict__ t_o, float* __restrict__ epr_o, float* __restrict__ eph_o,
    int32_t* __restrict__ epl_o, float* __restrict__ eacc_o, float* __restrict__ racc_o,
    float* __restrict__ hacc_o, float* __restrict__ lacc_o, int32_t* __restrict__ pidx_r,
    int32_t* __restrict__ pt_r, int32_t* __restrict__ act_r, float* __restrict__ logp_r,
    float* __restrict__ val_r, float* __restrict__ rew_r, float* __restrict__ hid_r,
    int32_t* __restrict__ done_r, int32_t* __restrict__ nidx_r) {
  const int A = genv.A;
  const int SA = S * A;
  const int C = A - 1;  // cdf entries per state
  extern __shared__ __align__(16) unsigned char smem[];
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
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const bool use_bits = env.mode != 0 || env.dry_mask != 0;
  const bool noise = env.drunk != nullptr;
  LaneState st{idx0[lane], t0[lane], epl0[lane], epr0[lane], eph0[lane]};
  float eacc = 0.f, racc = 0.f, hacc = 0.f, lacc = 0.f;
  for (int s = 0; s < T; ++s) {
    const size_t off = (size_t)s * N + lane;
    const int pidx = st.idx, pt = st.t;
    const float uu = u[off];
    const float* cdf = cd + pidx * C;
    int act = 0;  // the CHOSEN action
    for (int k = 0; k < C; ++k) act += uu >= cdf[k] ? 1 : 0;
    const int b = use_bits ? bits[off] : 0;
    int sm = 0, ra = 0;
    if (noise) {
      sm = stumble[off];
      ra = rand_a[off];
    }
    const LaneStep o = stoch_lane_step(env, st, act, b, sm, ra);

    pidx_r[off] = pidx;
    pt_r[off] = pt;
    act_r[off] = act;
    logp_r[off] = lp[pidx * A + act];
    val_r[off] = vl[pidx];
    rew_r[off] = o.reward;
    hid_r[off] = o.hidden;
    done_r[off] = o.done ? 1 : 0;
    nidx_r[off] = o.nxt;

    const float dx = o.done ? 1.f : 0.f;
    eacc = __fadd_rn(eacc, dx);
    racc = __fadd_rn(racc, __fmul_rn(dx, o.epr));
    hacc = __fadd_rn(hacc, __fmul_rn(dx, o.eph));
    lacc = __fadd_rn(lacc, __fmul_rn(dx, (float)o.epl));
  }
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

// Launch on `stream`; returns cudaGetLastError() (0 on success). cand0/cand1
// are read in mode 2 only; drunk may be null (no noise). smem selects the
// placement of the policy rows and the tables (1: shared memory, 0: device
// memory). A >= 2; actions drawn in rand_a and all indices must be in range:
// tables and rows are read unchecked.
extern "C" int ppo_stoch_collect_launch(
    const void* next, const void* reward, const void* hidden, const void* done,
    const void* cand0, const void* cand1, const void* drunk, int S, int A,
    int max_steps, int mode, int r0, int r1, int dry_nbits, int smem_rows,
    const void* logp_row, const void* cdf_row, const void* value_row, const void* idx0,
    const void* t0, const void* epr0, const void* eph0, const void* epl0, const void* u,
    const void* bits, const void* stumble, const void* rand_a, int T, int N, void* idx_o,
    void* t_o, void* epr_o, void* eph_o, void* epl_o, void* eacc_o, void* racc_o,
    void* hacc_o, void* lacc_o, void* pidx_r, void* pt_r, void* act_r, void* logp_r,
    void* val_r, void* rew_r, void* hid_r, void* done_r, void* nidx_r, void* stream) {
  if (N < 1 || T < 0 || A < 2 || mode < 0 || mode > 2 || dry_nbits < 0 ||
      dry_nbits > 30 || (mode == 2 && (cand0 == nullptr || cand1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StochEnv env{(const int32_t*)next, (const float*)reward, (const float*)hidden,
                     (const uint8_t*)done, (const int32_t*)cand0, (const int32_t*)cand1,
                     (const uint8_t*)drunk, A, max_steps, mode, r0, r1,
                     (1 << dry_nbits) - 1};
  const size_t smem = smem_rows ? (size_t)S * 2 * A * 4 +
                                      stoch_table_bytes(S, A, mode, drunk != nullptr)
                                : 0;
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
      (const int32_t*)epl0, (const float*)u, (const int32_t*)bits, (const int32_t*)stumble,
      (const int32_t*)rand_a, T, N, (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o,
      (float*)eph_o, (int32_t*)epl_o, (float*)eacc_o, (float*)racc_o, (float*)hacc_o,
      (float*)lacc_o, (int32_t*)pidx_r, (int32_t*)pt_r, (int32_t*)act_r, (float*)logp_r,
      (float*)val_r, (float*)rew_r, (float*)hid_r, (int32_t*)done_r, (int32_t*)nidx_r);
  return (int)cudaGetLastError();
}
