// One lane's step of a stochastic compiled env, shared by the stochastic
// rollout kernel (B7, stoch_rollout_kernel.cu), the stochastic fused
// tabular-Q kernel (B8, tabular_stoch_kernel.cu) and the stochastic DQN and
// PPO collect kernels (B9, dqn_stoch_kernel.cu; B10,
// ppo_stoch_collect_kernel.cu).
//
// The order is the reference's (safe_grid_agents_tpu/ops/
// stoch_rollout_kernel.py::_kernel, lines 102-157): tomato's drying clears
// the drawn watered bits of the index; whisky's noise replaces the action
// where the (dried) state is drunk and the stumble coin is set; the table
// gathers at (dried index, effective action); the timeout; the reset select
// (mode 0: r0; mode 1: the coin picks r0 or r1; mode 2: the coin picks the
// successor's carry candidate); then the episode accounting. Float sums run
// per lane in step order with round-to-nearest adds, so results are bitwise
// equal to the plain PyTorch version.
//
// The table pointers may point to shared memory (staged by the kernel) or
// to device memory (tables too large for a block, read through L1/L2;
// global_lane_step hoists the loads there).
#pragma once
#include <stdint.h>

struct StochEnv {
  const int32_t* next;    // [S*A] successor index
  const float* reward;    // [S*A]
  const float* hidden;    // [S*A]
  const uint8_t* done;    // [S*A] env-terminal flag
  const int32_t* cand0;   // [S*A] carry-reset candidate of the successor, coin 0 (mode 2)
  const int32_t* cand1;   // [S*A] ... coin 1 (mode 2)
  const uint8_t* drunk;   // [S] drunk flag (noise only), else null
  int A, max_steps, mode, r0, r1;
  int dry_mask;           // 2^K - 1 for K drying tomatoes, else 0
};

struct LaneState {
  int idx, t, epl;
  float epr, eph;
};

struct LaneStep {
  int nxt;       // pre-reset successor
  float reward;
  float hidden;  // the step's hidden reward
  bool done;
  float epr, eph;  // the episode's sums including this step
  int epl;
};

// Advances `lane` one step. `lane.idx` is the index the agent observed
// (before drying); `action` the chosen action; `bits` the reset coin or the
// packed dry coins; `stumble`/`rand_a` whisky's draws.
__device__ __forceinline__ LaneStep stoch_lane_step(const StochEnv& env, LaneState& lane,
                                                    int action, int bits, int stumble,
                                                    int rand_a) {
  int e = lane.idx;
  if (env.dry_mask) e -= e & env.dry_mask & bits;
  int a = action;
  if (env.drunk != nullptr && env.drunk[e] != 0 && stumble > 0) a = rand_a;
  const int k = e * env.A + a;
  LaneStep o;
  o.nxt = env.next[k];
  o.reward = env.reward[k];
  const int t1 = lane.t + 1;
  o.done = env.done[k] != 0 || t1 >= env.max_steps;
  int reset = env.r0;
  if (env.mode == 1) {
    reset = bits > 0 ? env.r1 : env.r0;
  } else if (env.mode == 2) {
    reset = bits > 0 ? env.cand1[k] : env.cand0[k];
  }
  o.epr = __fadd_rn(lane.epr, o.reward);
  o.hidden = env.hidden[k];
  o.eph = __fadd_rn(lane.eph, o.hidden);
  o.epl = lane.epl + 1;
  lane.idx = o.done ? reset : o.nxt;
  lane.t = o.done ? 0 : t1;
  lane.epr = o.done ? 0.f : o.epr;
  lane.eph = o.done ? 0.f : o.eph;
  lane.epl = o.done ? 0 : o.epl;
  return o;
}

// stoch_lane_step for tables in device memory (B7, B9): every entry of
// (e, a) is loaded before any select, so a carried reset's candidates do not
// wait on the done flag's load and a step makes one round trip to L2, not
// two. The arithmetic and its order are stoch_lane_step's.
__device__ __forceinline__ LaneStep global_lane_step(const StochEnv& env, LaneState& lane,
                                                     int action, int bits, int stumble,
                                                     int rand_a) {
  int e = lane.idx;
  if (env.dry_mask) e -= e & env.dry_mask & bits;
  int a = action;
  if (env.drunk != nullptr && env.drunk[e] != 0 && stumble > 0) a = rand_a;
  const int k = e * env.A + a;
  LaneStep o;
  o.nxt = env.next[k];
  o.reward = env.reward[k];
  o.hidden = env.hidden[k];
  const bool env_done = env.done[k] != 0;
  int c0 = 0, c1 = 0;
  if (env.mode == 2) {
    c0 = env.cand0[k];
    c1 = env.cand1[k];
  }
  const int t1 = lane.t + 1;
  o.done = env_done || t1 >= env.max_steps;
  int reset = env.r0;
  if (env.mode == 1) {
    reset = bits > 0 ? env.r1 : env.r0;
  } else if (env.mode == 2) {
    reset = bits > 0 ? c1 : c0;
  }
  o.epr = __fadd_rn(lane.epr, o.reward);
  o.eph = __fadd_rn(lane.eph, o.hidden);
  o.epl = lane.epl + 1;
  lane.idx = o.done ? reset : o.nxt;
  lane.t = o.done ? 0 : t1;
  lane.epr = o.done ? 0.f : o.epr;
  lane.eph = o.done ? 0.f : o.eph;
  lane.epl = o.done ? 0 : o.epl;
  return o;
}

// Bytes of shared memory the tables take, laid out by stage_tables.
__host__ __device__ inline size_t stoch_table_bytes(int S, int A, int mode, bool noise) {
  const size_t SA = (size_t)S * A;
  return SA * (13 + (mode == 2 ? 8 : 0)) + (noise ? (size_t)S : 0);
}

// Copies the tables of `g` into `smem` (4-byte arrays first, then the byte
// arrays) with the whole block, and returns the env pointing there. The
// caller synchronises the block before reading.
__device__ __forceinline__ StochEnv stage_tables(const StochEnv& g, int S,
                                                 unsigned char* smem) {
  const int SA = S * g.A;
  StochEnv s = g;
  int32_t* nx = reinterpret_cast<int32_t*>(smem);
  float* rw = reinterpret_cast<float*>(nx + SA);
  float* hd = rw + SA;
  int32_t* c0 = reinterpret_cast<int32_t*>(hd + SA);
  int32_t* c1 = c0 + (g.mode == 2 ? SA : 0);
  uint8_t* dn = reinterpret_cast<uint8_t*>(c1 + (g.mode == 2 ? SA : 0));
  uint8_t* dk = dn + SA;
  for (int c = threadIdx.x; c < SA; c += blockDim.x) {
    nx[c] = g.next[c];
    rw[c] = g.reward[c];
    hd[c] = g.hidden[c];
    dn[c] = g.done[c];
    if (g.mode == 2) {
      c0[c] = g.cand0[c];
      c1[c] = g.cand1[c];
    }
  }
  if (g.drunk != nullptr) {
    for (int c = threadIdx.x; c < S; c += blockDim.x) dk[c] = g.drunk[c];
  }
  s.next = nx;
  s.reward = rw;
  s.hidden = hd;
  s.done = dn;
  s.cand0 = g.mode == 2 ? c0 : nullptr;
  s.cand1 = g.mode == 2 ? c1 : nullptr;
  s.drunk = g.drunk != nullptr ? dk : nullptr;
  return s;
}
