// PPO collect: inverse-CDF act from frozen policy rows -> env step ->
// rollout records, for T steps, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/ppo_collect_kernel.py::_kernel
// (launched by ppo_collect_run through pl.pallas_call). The TPU kernel reads
// the env tables AND the policy rows (logp, cdf, value) through one f32
// one-hot matmul per step against a payload, because Mosaic rejects
// per-lane gathers. Here the 13-byte-per-(s, a) tables and the rows
// (4·S·(2A) bytes: logp [S, A], cdf [S, A-1], value [S]) sit in shared
// memory — 6,048 bytes for island, 108,864 for sokoban, so the launch opts
// in above 48 KB — and each lane reads its own entries.
//
// What bounds it on this card: device-memory traffic is the [T, N] uniform
// stream in (4 bytes per lane and step) and nine [T, N] record streams out
// (36 bytes), all coalesced (record row s is written at s·N + lane). That
// makes it bytes-bound on paper; at the PPO preset's width (N = 1024, 8
// blocks on 8 of 132 SMs) it is bound by the dependent chain of one lane's
// steps (uniform load -> row compare -> table read -> next state). The
// lane's state and episode accumulators stay in registers and the whole T
// loop runs inside the thread.
//
// Numerics: the action is Σ_{k<A-1} (u >= cdf[idx, k]); every recorded float
// is a gather of a precomputed row or table entry, and the episode totals
// follow the reference's update order (ppo_collect_kernel.py:119-130) in
// round-to-nearest intrinsics, so every output is bitwise the plain PyTorch
// version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

__global__ void __launch_bounds__(kThreads) ppo_collect_kernel(
    const int32_t* __restrict__ next, const float* __restrict__ reward,
    const float* __restrict__ hidden, const uint8_t* __restrict__ done_tab,
    const float* __restrict__ logp_row, const float* __restrict__ cdf_row,
    const float* __restrict__ value_row, int S, int A, int max_steps,
    int reset_idx, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0,
    const float* __restrict__ u, int T, int N, int32_t* __restrict__ idx_o,
    int32_t* __restrict__ t_o, float* __restrict__ epr_o,
    float* __restrict__ eph_o, int32_t* __restrict__ epl_o,
    float* __restrict__ eacc_o, float* __restrict__ racc_o,
    float* __restrict__ hacc_o, float* __restrict__ lacc_o,
    int32_t* __restrict__ pidx_r, int32_t* __restrict__ pt_r,
    int32_t* __restrict__ act_r, float* __restrict__ logp_r,
    float* __restrict__ val_r, float* __restrict__ rew_r,
    float* __restrict__ hid_r, int32_t* __restrict__ done_r,
    int32_t* __restrict__ nidx_r) {
  const int SA = S * A;
  const int C = A - 1;  // cdf entries per state
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_next = reinterpret_cast<int32_t*>(smem);
  float* s_rew = reinterpret_cast<float*>(s_next + SA);
  float* s_hid = s_rew + SA;
  float* s_logp = s_hid + SA;
  float* s_cdf = s_logp + SA;
  float* s_val = s_cdf + S * C;
  uint8_t* s_done = reinterpret_cast<uint8_t*>(s_val + S);
  for (int c = threadIdx.x; c < SA; c += blockDim.x) {
    s_next[c] = next[c];
    s_rew[c] = reward[c];
    s_hid[c] = hidden[c];
    s_logp[c] = logp_row[c];
    s_done[c] = done_tab[c];
  }
  for (int c = threadIdx.x; c < S * C; c += blockDim.x) s_cdf[c] = cdf_row[c];
  for (int c = threadIdx.x; c < S; c += blockDim.x) s_val[c] = value_row[c];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  int idx = idx0[lane], t = t0[lane], epl = epl0[lane];
  float epr = epr0[lane], eph = eph0[lane];
  float eacc = 0.f, racc = 0.f, hacc = 0.f, lacc = 0.f;
  for (int s = 0; s < T; ++s) {
    const size_t off = (size_t)s * N + lane;
    const float uu = u[off];
    const float* cdf = s_cdf + idx * C;
    int act = 0;
    for (int k = 0; k < C; ++k) act += uu >= cdf[k] ? 1 : 0;
    const int k = idx * A + act;
    const int nxt = s_next[k];
    const float r = s_rew[k];
    const float h = s_hid[k];
    const int t1 = t + 1;
    const bool done = s_done[k] != 0 || t1 >= max_steps;

    pidx_r[off] = idx;
    pt_r[off] = t;
    act_r[off] = act;
    logp_r[off] = s_logp[k];
    val_r[off] = s_val[idx];
    rew_r[off] = r;
    hid_r[off] = h;
    done_r[off] = done ? 1 : 0;
    nidx_r[off] = nxt;

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
  idx_o[lane] = idx;
  t_o[lane] = t;
  epr_o[lane] = epr;
  eph_o[lane] = eph;
  epl_o[lane] = epl;
  eacc_o[lane] = eacc;
  racc_o[lane] = racc;
  hacc_o[lane] = hacc;
  lacc_o[lane] = lacc;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Indices
// must lie in [0, S); A >= 2. Shared memory: 13·S·A bytes of tables plus
// 4·S·2A of policy rows (ops/ppo_collect_kernel.py::smem_bytes).
extern "C" int ppo_collect_launch(
    const void* next, const void* reward, const void* hidden,
    const void* done_tab, const void* logp_row, const void* cdf_row,
    const void* value_row, int S, int A, int max_steps, int reset_idx,
    const void* idx0, const void* t0, const void* epr0, const void* eph0,
    const void* epl0, const void* u, int T, int N, void* idx_o, void* t_o,
    void* epr_o, void* eph_o, void* epl_o, void* eacc_o, void* racc_o,
    void* hacc_o, void* lacc_o, void* pidx_r, void* pt_r, void* act_r,
    void* logp_r, void* val_r, void* rew_r, void* hid_r, void* done_r,
    void* nidx_r, void* stream) {
  const size_t smem = (size_t)S * A * 13 + (size_t)S * 2 * A * 4;
  if (smem > kMaxSmem || N < 1 || T < 0 || A < 2)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ppo_collect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kThreads - 1) / kThreads;
  ppo_collect_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)next, (const float*)reward, (const float*)hidden,
      (const uint8_t*)done_tab, (const float*)logp_row, (const float*)cdf_row,
      (const float*)value_row, S, A, max_steps, reset_idx,
      (const int32_t*)idx0, (const int32_t*)t0, (const float*)epr0,
      (const float*)eph0, (const int32_t*)epl0, (const float*)u, T, N,
      (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o, (float*)eph_o,
      (int32_t*)epl_o, (float*)eacc_o, (float*)racc_o, (float*)hacc_o,
      (float*)lacc_o, (int32_t*)pidx_r, (int32_t*)pt_r, (int32_t*)act_r,
      (float*)logp_r, (float*)val_r, (float*)rew_r, (float*)hid_r,
      (int32_t*)done_r, (int32_t*)nidx_r);
  return (int)cudaGetLastError();
}
