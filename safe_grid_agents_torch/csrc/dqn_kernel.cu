// DQN collect: ε-greedy act from a frozen greedy row -> env step -> replay
// record, for T steps, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/dqn_kernel.py::_kernel (launched by
// dqn_collect_run through pl.pallas_call). The TPU kernel reads the tables
// AND the greedy action through one bf16 one-hot matmul against a payload
// (next index split into hi/lo bytes to stay bf16-exact), because Mosaic
// rejects per-lane gathers. Here the 13-byte-per-(s, a) tables and the
// greedy row (one byte per state) sit in shared memory (13·S·A + S bytes:
// 68,688 for sokoban, above the 48 KB default, so the launch opts in) and
// each lane reads its own entries.
//
// What bounds it on this card: device-memory traffic is the two [T, N]
// draw streams in (8 bytes per lane and step) and the six [T, N] record
// streams out (24 bytes), all coalesced (record row s is written at
// s·N + lane, so neighbouring lanes write neighbouring addresses). On
// paper that makes it bytes-bound; at the trainer's width (N = 128, one
// block on one SM) it is bound by the dependent chain of one lane's steps
// (draw load -> table read -> next state). The design keeps the lane's
// state and its four episode accumulators in registers and loops over all
// T inside the thread.
//
// Numerics: ε uses round-to-nearest intrinsics (as the tabular kernel does)
// so no FMA contraction moves a `u < ε` decision; the episode totals follow
// the reference's update order (dqn_kernel.py:155-166). Every output is
// bitwise the plain PyTorch version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

__global__ void __launch_bounds__(kThreads) dqn_collect_kernel(
    const int32_t* __restrict__ next, const float* __restrict__ reward,
    const float* __restrict__ hidden, const uint8_t* __restrict__ done_tab,
    const int32_t* __restrict__ greedy_row, int S, int A, int max_steps,
    int reset_idx, float eps0, float eps_delta, float anneal, int use_hidden,
    const int32_t* __restrict__ idx0, const int32_t* __restrict__ t0,
    const float* __restrict__ epr0, const float* __restrict__ eph0,
    const int32_t* __restrict__ epl0, const int64_t* __restrict__ step0,
    const int32_t* __restrict__ rand_a, const float* __restrict__ u, int T,
    int N, int32_t* __restrict__ idx_o, int32_t* __restrict__ t_o,
    float* __restrict__ epr_o, float* __restrict__ eph_o,
    int32_t* __restrict__ epl_o, int64_t* __restrict__ step_o,
    float* __restrict__ eacc_o, float* __restrict__ racc_o,
    float* __restrict__ hacc_o, float* __restrict__ lacc_o,
    int32_t* __restrict__ pidx_r, int32_t* __restrict__ pt_r,
    int32_t* __restrict__ act_r, float* __restrict__ rew_r,
    int32_t* __restrict__ nidx_r, int32_t* __restrict__ done_r) {
  const int SA = S * A;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_next = reinterpret_cast<int32_t*>(smem);
  float* s_rew = reinterpret_cast<float*>(s_next + SA);
  float* s_hid = s_rew + SA;
  uint8_t* s_done = reinterpret_cast<uint8_t*>(s_hid + SA);
  uint8_t* s_greedy = s_done + SA;
  for (int c = threadIdx.x; c < SA; c += blockDim.x) {
    s_next[c] = next[c];
    s_rew[c] = reward[c];
    s_hid[c] = hidden[c];
    s_done[c] = done_tab[c];
  }
  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    s_greedy[c] = (uint8_t)greedy_row[c];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t st0 = *step0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *step_o = st0 + (int64_t)T * N;
  if (lane >= N) return;
  int idx = idx0[lane], t = t0[lane], epl = epl0[lane];
  float epr = epr0[lane], eph = eph0[lane];
  float eacc = 0.f, racc = 0.f, hacc = 0.f, lacc = 0.f;
  for (int s = 0; s < T; ++s) {
    // Linear ε anneal from the global step counter (dqn_kernel.py:125-127).
    const int64_t step_t = st0 + (int64_t)s * N;
    float frac = __fdiv_rn(__ll2float_rn(step_t), anneal);
    frac = fminf(fmaxf(frac, 0.f), 1.f);
    const float eps_t = __fadd_rn(eps0, __fmul_rn(frac, eps_delta));

    const size_t off = (size_t)s * N + lane;
    const int act = u[off] < eps_t ? rand_a[off] : (int)s_greedy[idx];
    const int k = idx * A + act;
    const int nxt = s_next[k];
    const float r = s_rew[k];
    const float h = s_hid[k];
    const int t1 = t + 1;
    const bool done = s_done[k] != 0 || t1 >= max_steps;

    pidx_r[off] = idx;
    pt_r[off] = t;
    act_r[off] = act;
    rew_r[off] = use_hidden ? h : r;
    nidx_r[off] = nxt;
    done_r[off] = done ? 1 : 0;

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

// Launch on `stream`; returns cudaGetLastError() (0 on success). Actions in
// rand_a and the greedy row must lie in [0, A), indices in [0, S).
extern "C" int dqn_collect_launch(
    const void* next, const void* reward, const void* hidden,
    const void* done_tab, const void* greedy_row, int S, int A,
    int max_steps, int reset_idx, float eps0, float eps_delta, float anneal,
    int use_hidden, const void* idx0, const void* t0, const void* epr0,
    const void* eph0, const void* epl0, const void* step0,
    const void* rand_a, const void* u, int T, int N, void* idx_o, void* t_o,
    void* epr_o, void* eph_o, void* epl_o, void* step_o, void* eacc_o,
    void* racc_o, void* hacc_o, void* lacc_o, void* pidx_r, void* pt_r,
    void* act_r, void* rew_r, void* nidx_r, void* done_r, void* stream) {
  const size_t smem = (size_t)S * A * 13 + (size_t)S;
  if (smem > kMaxSmem || N < 1 || T < 0 || A > 255)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dqn_collect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kThreads - 1) / kThreads;
  dqn_collect_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)next, (const float*)reward, (const float*)hidden,
      (const uint8_t*)done_tab, (const int32_t*)greedy_row, S, A, max_steps,
      reset_idx, eps0, eps_delta, anneal, use_hidden, (const int32_t*)idx0,
      (const int32_t*)t0, (const float*)epr0, (const float*)eph0,
      (const int32_t*)epl0, (const int64_t*)step0, (const int32_t*)rand_a,
      (const float*)u, T, N, (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o,
      (float*)eph_o, (int32_t*)epl_o, (int64_t*)step_o, (float*)eacc_o,
      (float*)racc_o, (float*)hacc_o, (float*)lacc_o, (int32_t*)pidx_r,
      (int32_t*)pt_r, (int32_t*)act_r, (float*)rew_r, (int32_t*)nidx_r,
      (int32_t*)done_r);
  return (int)cudaGetLastError();
}
