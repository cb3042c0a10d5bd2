// DQN collect on a stochastic compiled env: ε-greedy act from a frozen greedy
// row -> env step with the stochastic mechanics -> replay record, for T
// steps, one thread per lane.
//
// Replaces safe_grid_agents_tpu/ops/dqn_stoch_kernel.py::_kernel (launched
// by dqn_stoch_collect_run through pl.pallas_call): B3's design
// (dqn_kernel.cu: the lane's state and episode sums in registers, the whole
// T loop inside the thread) with B7's per-lane step from stoch_step.cuh —
// coin resets (mode 1), carried resets (mode 2), whisky's stumble, tomato's
// drying. Two distinctions are kept exact, as in B8:
//   * the greedy action is read at the index the agent observed (pre-dry),
//     and the record stores that index;
//   * the record stores the CHOSEN action (ε-greedy); the EFFECTIVE one
//     (whisky's stumble) steps the env at the DRIED index.
// The TPU kernel reads the tables and the greedy row through one-hot
// matmuls against a hi/lo bf16 payload, because Mosaic rejects per-lane
// gathers; here each lane reads its own entries.
//
// Where the tables and the greedy row (one byte per state) live is a
// template parameter: shared memory when they fit in one block's 227 KB
// (tomato 70 KB, friend at cap 15 ~184 KB), device memory otherwise (friend
// at cap 127: 1.5 MB, read through L1/L2; the greedy row is then read as
// the caller's int32 row).
//
// What bounds it on this card: device-memory traffic is the five [T, N]
// draw streams in (rand_a, u, bits, stumble, rand2: up to 20 bytes per
// lane-step; streams an env does not use are not read) and the six [T, N]
// record streams out (24 bytes), all coalesced. On paper that is bytes-bound;
// at the trainer's width (N = 128, one block on one SM) it is bound by the
// dependent chain of one lane's steps (draw load -> greedy read -> table read
// -> next state).
//
// Numerics: ε uses round-to-nearest intrinsics (as B3) so no FMA contraction
// moves a `u < ε` decision; the step counter is int64; the episode sums run
// in step order with round-to-nearest adds. Every output is bitwise the
// plain PyTorch version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stoch_step.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

template <bool kSmemTables>
__global__ void __launch_bounds__(kThreads) dqn_stoch_kernel(
    StochEnv genv, int S, const int32_t* __restrict__ greedy_row, float eps0,
    float eps_delta, float anneal, int use_hidden, const int32_t* __restrict__ idx0,
    const int32_t* __restrict__ t0, const float* __restrict__ epr0,
    const float* __restrict__ eph0, const int32_t* __restrict__ epl0,
    const int64_t* __restrict__ step0, const int32_t* __restrict__ rand_a,
    const float* __restrict__ u, const int32_t* __restrict__ bits,
    const int32_t* __restrict__ stumble, const int32_t* __restrict__ rand2, int T, int N,
    int32_t* __restrict__ idx_o, int32_t* __restrict__ t_o, float* __restrict__ epr_o,
    float* __restrict__ eph_o, int32_t* __restrict__ epl_o, int64_t* __restrict__ step_o,
    float* __restrict__ eacc_o, float* __restrict__ racc_o, float* __restrict__ hacc_o,
    float* __restrict__ lacc_o, int32_t* __restrict__ pidx_r, int32_t* __restrict__ pt_r,
    int32_t* __restrict__ act_r, float* __restrict__ rew_r, int32_t* __restrict__ nidx_r,
    int32_t* __restrict__ done_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  StochEnv env = genv;
  const uint8_t* s_greedy = nullptr;
  if (kSmemTables) {
    env = stage_tables(genv, S, smem);
    uint8_t* g8 = smem + stoch_table_bytes(S, genv.A, genv.mode, genv.drunk != nullptr);
    for (int c = threadIdx.x; c < S; c += blockDim.x) g8[c] = (uint8_t)greedy_row[c];
    s_greedy = g8;
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t st0 = *step0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *step_o = st0 + (int64_t)T * N;
  if (lane >= N) return;
  const bool use_bits = env.mode != 0 || env.dry_mask != 0;
  const bool noise = env.drunk != nullptr;
  LaneState st{idx0[lane], t0[lane], epl0[lane], epr0[lane], eph0[lane]};
  float eacc = 0.f, racc = 0.f, hacc = 0.f, lacc = 0.f;
  for (int s = 0; s < T; ++s) {
    // Linear ε anneal from the global step counter (dqn_stoch_kernel.py:98-100).
    const int64_t step_t = st0 + (int64_t)s * N;
    float frac = __fdiv_rn(__ll2float_rn(step_t), anneal);
    frac = fminf(fmaxf(frac, 0.f), 1.f);
    const float eps_t = __fadd_rn(eps0, __fmul_rn(frac, eps_delta));

    const size_t off = (size_t)s * N + lane;
    const int pidx = st.idx, pt = st.t;
    const int greedy = kSmemTables ? (int)s_greedy[pidx] : greedy_row[pidx];
    const int act = u[off] < eps_t ? rand_a[off] : greedy;  // the CHOSEN action
    const int b = use_bits ? bits[off] : 0;
    int sm = 0, r2 = 0;
    if (noise) {
      sm = stumble[off];
      r2 = rand2[off];
    }
    const LaneStep o = stoch_lane_step(env, st, act, b, sm, r2);

    pidx_r[off] = pidx;
    pt_r[off] = pt;
    act_r[off] = act;
    rew_r[off] = use_hidden ? o.hidden : o.reward;
    nidx_r[off] = o.nxt;
    done_r[off] = o.done ? 1 : 0;

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
// are read in mode 2 only; drunk may be null (no noise). smem_tables selects
// the placement of the tables and the greedy row (1: shared memory, 0:
// device memory). The greedy row and the actions in rand_a/rand2 must lie in
// [0, A), indices in [0, S): tables are read unchecked.
extern "C" int dqn_stoch_collect_launch(
    const void* next, const void* reward, const void* hidden, const void* done,
    const void* cand0, const void* cand1, const void* drunk, int S, int A,
    int max_steps, int mode, int r0, int r1, int dry_nbits, int smem_tables,
    const void* greedy_row, float eps0, float eps_delta, float anneal, int use_hidden,
    const void* idx0, const void* t0, const void* epr0, const void* eph0,
    const void* epl0, const void* step0, const void* rand_a, const void* u,
    const void* bits, const void* stumble, const void* rand2, int T, int N, void* idx_o,
    void* t_o, void* epr_o, void* eph_o, void* epl_o, void* step_o, void* eacc_o,
    void* racc_o, void* hacc_o, void* lacc_o, void* pidx_r, void* pt_r, void* act_r,
    void* rew_r, void* nidx_r, void* done_r, void* stream) {
  if (N < 1 || T < 0 || A > 255 || mode < 0 || mode > 2 || dry_nbits < 0 ||
      dry_nbits > 30 || (mode == 2 && (cand0 == nullptr || cand1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StochEnv env{(const int32_t*)next, (const float*)reward, (const float*)hidden,
                     (const uint8_t*)done, (const int32_t*)cand0, (const int32_t*)cand1,
                     (const uint8_t*)drunk, A, max_steps, mode, r0, r1,
                     (1 << dry_nbits) - 1};
  const size_t smem =
      smem_tables ? stoch_table_bytes(S, A, mode, drunk != nullptr) + (size_t)S : 0;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = smem_tables ? dqn_stoch_kernel<true> : dqn_stoch_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      env, S, (const int32_t*)greedy_row, eps0, eps_delta, anneal, use_hidden,
      (const int32_t*)idx0, (const int32_t*)t0, (const float*)epr0, (const float*)eph0,
      (const int32_t*)epl0, (const int64_t*)step0, (const int32_t*)rand_a, (const float*)u,
      (const int32_t*)bits, (const int32_t*)stumble, (const int32_t*)rand2, T, N,
      (int32_t*)idx_o, (int32_t*)t_o, (float*)epr_o, (float*)eph_o, (int32_t*)epl_o,
      (int64_t*)step_o, (float*)eacc_o, (float*)racc_o, (float*)hacc_o, (float*)lacc_o,
      (int32_t*)pidx_r, (int32_t*)pt_r, (int32_t*)act_r, (float*)rew_r, (int32_t*)nidx_r,
      (int32_t*)done_r);
  return (int)cudaGetLastError();
}
