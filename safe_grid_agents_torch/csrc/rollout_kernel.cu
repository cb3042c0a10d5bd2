// T-step rollout of a deterministic-reset compiled env, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/rollout_kernel.py::_kernel (launched by
// _run through pl.pallas_call). The TPU kernel reads the tables through a
// one-hot matmul because Mosaic rejects per-lane gathers; CUDA has no such
// limit, so here each lane reads its (idx, a) entry straight from the tables
// staged in shared memory (13 bytes per (s, a): next i32, reward f32,
// hidden f32, done u8).
//
// What bounds it on this card: the only device-memory traffic in the loop is
// the action matrix, 4 bytes per lane and step, read coalesced. At the main
// path's width (N = 4096 lanes, 32 blocks of 128 on 132 SMs) each lane's
// step t+1 waits on step t through a dependent shared-memory load, so the
// kernel is bound by that latency chain rather than by bytes. The design
// keeps all state and accumulators in registers and loops over all T inside
// the thread (no T blocking); hiding the latency (more lanes per SM,
// software pipelining of the action loads) is later work.
//
// Update order per step is the reference's (rollout_kernel.py:107-122):
// done = done_tab | t+1 >= max_steps; racc += reward; eacc += done;
// facc += done * epr (epr already holds this step's reward); then the
// auto-reset selects. All values are exact, so outputs are bitwise equal to
// the plain PyTorch version and to the JAX kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

__global__ void __launch_bounds__(kThreads) rollout_kernel(
    const int32_t* __restrict__ next, const float* __restrict__ reward,
    const float* __restrict__ hidden, const uint8_t* __restrict__ done_tab,
    int SA, int A, int max_steps, int reset_idx,
    const int32_t* __restrict__ idx0, const int32_t* __restrict__ t0,
    const float* __restrict__ epr0, const float* __restrict__ eph0,
    const int32_t* __restrict__ epl0,
    const int32_t* __restrict__ actions, int T, int N,
    int32_t* __restrict__ idx_o, int32_t* __restrict__ t_o,
    float* __restrict__ epr_o, float* __restrict__ eph_o,
    int32_t* __restrict__ epl_o, float* __restrict__ racc_o,
    float* __restrict__ eacc_o, float* __restrict__ facc_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_next = reinterpret_cast<int32_t*>(smem);
  float* s_rew = reinterpret_cast<float*>(s_next + SA);
  float* s_hid = s_rew + SA;
  uint8_t* s_done = reinterpret_cast<uint8_t*>(s_hid + SA);
  for (int c = threadIdx.x; c < SA; c += blockDim.x) {
    s_next[c] = next[c];
    s_rew[c] = reward[c];
    s_hid[c] = hidden[c];
    s_done[c] = done_tab[c];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  int idx = idx0[lane], t = t0[lane], epl = epl0[lane];
  float epr = epr0[lane], eph = eph0[lane];
  float racc = 0.f, eacc = 0.f, facc = 0.f;
  for (int s = 0; s < T; ++s) {
    const int k = idx * A + actions[(size_t)s * N + lane];
    const int nxt = s_next[k];
    const float r = s_rew[k];
    const int t1 = t + 1;
    const bool done = s_done[k] != 0 || t1 >= max_steps;
    const float dx = done ? 1.f : 0.f;
    epr = __fadd_rn(epr, r);
    eph = __fadd_rn(eph, s_hid[k]);
    epl += 1;
    racc = __fadd_rn(racc, r);
    eacc = __fadd_rn(eacc, dx);
    facc = __fadd_rn(facc, __fmul_rn(dx, epr));
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
  racc_o[lane] = racc;
  eacc_o[lane] = eacc;
  facc_o[lane] = facc;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Actions
// must lie in [0, A) and indices in [0, S): the tables are read unchecked.
extern "C" int rollout_launch(
    const void* next, const void* reward, const void* hidden,
    const void* done_tab, int S, int A, int max_steps, int reset_idx,
    const void* idx0, const void* t0, const void* epr0, const void* eph0,
    const void* epl0, const void* actions, int T, int N,
    void* idx_o, void* t_o, void* epr_o, void* eph_o, void* epl_o,
    void* racc_o, void* eacc_o, void* facc_o, void* stream) {
  const int SA = S * A;
  const size_t smem = (size_t)SA * 13;
  if (smem > kMaxSmem || N < 1 || T < 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kThreads - 1) / kThreads;
  rollout_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)next, (const float*)reward, (const float*)hidden,
      (const uint8_t*)done_tab, SA, A, max_steps, reset_idx,
      (const int32_t*)idx0, (const int32_t*)t0, (const float*)epr0,
      (const float*)eph0, (const int32_t*)epl0, (const int32_t*)actions, T, N,
      (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o, (float*)eph_o,
      (int32_t*)epl_o, (float*)racc_o, (float*)eacc_o, (float*)facc_o);
  return (int)cudaGetLastError();
}
