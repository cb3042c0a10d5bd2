// DQN update, grid route: U sampled TD updates of a two-hidden-layer ReLU
// Q-net in one cooperative launch over every SM — forward, Huber loss,
// hand-derived backward, Adam and the scheduled target sync, update after
// update.
//
// Replaces safe_grid_agents_tpu/ops/dqn_update_kernel.py::_kernel (launched
// by dqn_update_run through pl.pallas_call) for the shapes that the cluster
// design (dqn_update_kernel.cu) cannot hold: it keeps each block's column
// slices of all four parameter sets in shared memory, so a wide net (e.g.
// hidden 512) or a large batch (e.g. B = 4096) does not fit 16 blocks.
// ops/dqn_update_kernel.py::route picks this kernel from the shape alone,
// before the launch. The TPU kernel reads the batch's observations through
// one-hot matmuls against a fold over ALL states, recomputed after every
// update, because Mosaic rejects row gathers; here each product gathers
// its B observation rows O[idx] straight from the [S, D] table.
//
// What bounds it on this card: update u+1 reads the parameters update u
// wrote, so the U updates are a serial chain; an update at hidden 512,
// B = 128 is ~0.4 GFLOP, at width 128, B = 4096 ~1.3 GFLOP: a few µs of the
// card's tensor cores each, so an update is bound by the latency of its
// phases and grid barriers, not by the card's rates. The design: one
// persistent block per co-resident slot (tile_gemm.cuh: two 256-thread
// blocks an SM), the U updates looping inside the kernel with a grid
// barrier between dependent phases, every product cut into 64 × 64 output
// tiles spread over the grid and run on the tensor cores in 3xTF32. An
// update is six phases:
//
//   1. layer 1: x1 = relu(O[idx]·w1 + b1) of the online net on s (and, for
//      double-Q, on s') and of the target net on s';
//   2. layer 2: x2 = relu(x1·w2 + b2) of the same passes;
//   3. per sample, one warp: the heads, the TD target (double-Q: the online
//      net picks a* by first max), the Huber loss and its derivative dqs;
//      the head's backward ∂x2 = dqs·w3[:, a] masked by x2 > 0 (old w3);
//   4. ∂x1 = ∂x2·w2ᵀ masked by x1 > 0 (old w2); the head's and layer 2's
//      weight and bias gradients, each summed over the batch in split-K
//      parts of 512 samples (the bias gradient rides along as a row of
//      ones in A);
//   5. layer 1's weight and bias gradients, O[s]ᵀ·∂x1, in the same parts;
//   6. every parameter element's parts joined in part order by ONE thread,
//      which hands the gradient straight to Adam (optax.adam: μ = (1−β1)g +
//      β1μ, ν = (1−β2)g² + β2ν, bias corrections 1 − βᵗ, p += −lr·μ̂/(√ν̂ +
//      ε), no clip, in round-to-nearest intrinsics) and, when the target
//      sync falls on this update, copies the new value into the target;
//      one warp sums the Huber losses into the running loss.
//
// The parameter sets, the batch's activations and the gradient parts live
// in device memory (L2-resident at these sizes). Every sum has one owner
// that adds in a fixed order and no float atomics are used, so the kernel
// is reproducible run to run; the plain PyTorch version differs by rounding
// only (summation order, 3xTF32 products).
#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

// Phase stamps of update u (tools/trace_learners.py), compiled only with
// -DSGA_TRACE: after each grid barrier, block 0's thread 0 records
// %globaltimer (ns). Without it SGA_STAMP is empty.
#ifdef SGA_TRACE
constexpr int kStampU = 256, kStampN = 8;
__device__ long long g_stamps[kStampU * kStampN];
#define SGA_STAMP(i)                                                        \
  do {                                                                      \
    if (threadIdx.x == 0 && blockIdx.x == 0 && u < kStampU) {               \
      long long now;                                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));               \
      g_stamps[u * kStampN + (i)] = now;                                    \
    }                                                                       \
  } while (0)
#else
#define SGA_STAMP(i) \
  do {               \
  } while (0)
#endif

struct Dims {
  int D, H1, H2, A, B;
  int dq;  // double-Q: the online net also runs on s'
  int R;   // forward rows: online on s, target on s', (online on s')
};

__host__ __device__ Dims make_dims(int D, int H1, int H2, int A, int B, int dq) {
  Dims d;
  d.D = D;
  d.H1 = H1;
  d.H2 = H2;
  d.A = A;
  d.B = B;
  d.dq = dq ? 1 : 0;
  d.R = (dq ? 3 : 2) * B;
  return d;
}

// Scratch offsets (floats): the passes' activations x1 [R, H1] and x2
// [R, H2] (rows [0, B) online on s, [B, 2B) target on s', [2B, 3B) online
// on s'), the head derivative dq [B, A] (dqs in the taken action's
// column), the Huber losses [B], ∂x2 [B, H2], ∂x1 [B, H1], the split-K parts
// of the three gradient products, and the running loss; each buffer starts
// on a 16-byte boundary.
struct Scratch {
  size_t x1, x2, dq, hub, g2, g1, p3, p2, p1, loss, total;
};

__host__ __device__ Scratch layout(const Dims& d) {
  Scratch s;
  const size_t parts = tg::parts(d.B);
  s.x1 = 0;
  s.x2 = tg::r4(s.x1 + (size_t)d.R * d.H1);
  s.dq = tg::r4(s.x2 + (size_t)d.R * d.H2);
  s.hub = tg::r4(s.dq + (size_t)d.B * d.A);
  s.g2 = tg::r4(s.hub + d.B);
  s.g1 = tg::r4(s.g2 + (size_t)d.B * d.H2);
  s.p3 = tg::r4(s.g1 + (size_t)d.B * d.H1);
  s.p2 = tg::r4(s.p3 + parts * (d.H2 + 1) * d.A);
  s.p1 = tg::r4(s.p2 + parts * (d.H1 + 1) * d.H2);
  s.loss = tg::r4(s.p1 + parts * (d.D + 1) * d.H1);
  s.total = s.loss + 1;
  return s;
}

struct Net {
  float *w1, *b1, *w2, *b2, *w3, *b3;
};

__host__ __device__ Net net_at(float* base, const Dims& d) {
  Net n;
  n.w1 = base;
  n.b1 = n.w1 + (size_t)d.D * d.H1;
  n.w2 = n.b1 + d.H1;
  n.b2 = n.w2 + (size_t)d.H1 * d.H2;
  n.w3 = n.b2 + d.H2;
  n.b3 = n.w3 + (size_t)d.H2 * d.A;
  return n;
}

// The products of one update: layer 1 and layer 2 of each pass (phases 1
// and 2), ∂x1 and the head's and layer 2's gradient parts (phase 4), layer
// 1's gradient parts (phase 5). s and n are the update's state rows.
struct Plan {
  tg::Job l1[3], l2[3], bwd[3], gw1[1];
  int passes;
};

__host__ __device__ Plan plan(const Dims& d, const Net& on, const Net& tn, const float* obs,
                              const int32_t* s, const int32_t* n, float* scratch) {
  using namespace tg;
  const Scratch sc = layout(d);
  float* x1 = scratch + sc.x1;
  float* x2 = scratch + sc.x2;
  const size_t B = d.B;
  Plan p;
  p.passes = d.dq ? 3 : 2;
  const Net* nets[3] = {&on, &tn, &on};
  const int32_t* rows[3] = {s, n, n};
  for (int q = 0; q < p.passes; ++q) {
    const Net& w = *nets[q];
    p.l1[q] = job(opnd(obs, d.D, 0, d.B, rows[q]), opnd(w.w1, d.H1, 1, d.H1), d.B, d.H1, d.D,
                  false, kReluBias, x1 + q * B * d.H1, d.H1, w.b1);
    p.l2[q] = job(opnd(x1 + q * B * d.H1, d.H1, 0, d.B), opnd(w.w2, d.H2, 1, d.H2), d.B, d.H2,
                  d.H1, false, kReluBias, x2 + q * B * d.H2, d.H2, w.b2);
  }
  float* g2 = scratch + sc.g2;
  float* g1 = scratch + sc.g1;
  // ∂x1 = ∂x2·w2ᵀ, masked by the online pass's x1 > 0.
  p.bwd[0] = job(opnd(g2, d.H2, 0, d.B), opnd(on.w2, d.H2, 0, d.H1), d.B, d.H1, d.H2, false,
                 kReluMask, g1, d.H1, nullptr, x1);
  // [gw3; gb3] = [x2; 1]ᵀ·dq, [gw2; gb2] = [x1; 1]ᵀ·∂x2.
  p.bwd[1] = job(opnd(x2, d.H2, 1, d.H2, nullptr, d.H2), opnd(scratch + sc.dq, d.A, 1, d.A),
                 d.H2 + 1, d.A, d.B, true, kStore, scratch + sc.p3, d.A);
  p.bwd[2] = job(opnd(x1, d.H1, 1, d.H1, nullptr, d.H1), opnd(g2, d.H2, 1, d.H2), d.H1 + 1,
                 d.H2, d.B, true, kStore, scratch + sc.p2, d.H2);
  // [gw1; gb1] = [O[s]; 1]ᵀ·∂x1.
  p.gw1[0] = job(opnd(obs, d.D, 1, d.D, s, d.D), opnd(g1, d.H1, 1, d.H1), d.D + 1, d.H1, d.B,
                 true, kStore, scratch + sc.p1, d.H1);
  return p;
}

struct Adam {
  float b1, omb1, b2, omb2, c1, c2, eps, neglr;
};

__device__ __forceinline__ float adam_step(float* p, float* m, float* v, size_t i, float g,
                                           const Adam& k) {
  const float mm = __fadd_rn(__fmul_rn(k.omb1, g), __fmul_rn(k.b1, m[i]));
  const float vv = __fadd_rn(__fmul_rn(k.omb2, __fmul_rn(g, g)), __fmul_rn(k.b2, v[i]));
  m[i] = mm;
  v[i] = vv;
  const float mh = __fdiv_rn(mm, k.c1);
  const float vh = __fdiv_rn(vv, k.c2);
  const float upd = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), k.eps));
  const float np = __fadd_rn(p[i], __fmul_rn(k.neglr, upd));
  p[i] = np;
  return np;
}

// Σ over the warp's lanes, in a fixed butterfly (every lane ends with the
// same bits).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// x·w[:, a] + b[a] for a row x of width H and w [H, A], by one warp.
__device__ __forceinline__ float head(const float* x, const float* w, const float* b, int H,
                                      int A, int a) {
  float acc = 0.f;
  for (int h = threadIdx.x & 31; h < H; h += 32) acc = fmaf(x[h], w[(size_t)h * A + a], acc);
  return __fadd_rn(warp_sum(acc), b[a]);
}

struct Args {
  const float* obs;
  Dims d;
  float* state;
  size_t P;
  const int64_t* count0;
  const int64_t* upd0;
  const int32_t* s_idx;
  const int32_t* n_idx;
  const int32_t* act;
  const float* rew;
  const uint8_t* done;
  int U;
  float lr, gamma_n, beta1, omb1, beta2, omb2, eps;
  int sync_every;
  float* scratch;
  int64_t* count_o;
  int64_t* upd_o;
  float* loss_o;
};

__global__ void __launch_bounds__(tg::kThreads, tg::kBlocksPerSm)
    dqn_update_grid_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];  // the copy ring (tg::kSmemFloats)
  __shared__ Plan p;  // the update's products, built by thread 0
  cg::grid_group grid = cg::this_grid();
  const Dims& d = a.d;
  const Scratch sc = layout(d);
  const Net on = net_at(a.state, d);
  const Net tn = net_at(a.state + a.P, d);
  const Net mu = net_at(a.state + 2 * a.P, d);
  const Net nu = net_at(a.state + 3 * a.P, d);
  float* x2 = a.scratch + sc.x2;
  float* dqb = a.scratch + sc.dq;
  float* hubs = a.scratch + sc.hub;
  float* g2 = a.scratch + sc.g2;
  float* loss = a.scratch + sc.loss;
  const int64_t c0 = *a.count0, n0 = *a.upd0;
  const float inv_b = __fdiv_rn(1.f, (float)d.B);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (tg::kThreads / 32);
  const int gwarp = blockIdx.x * (tg::kThreads / 32) + (threadIdx.x >> 5);
  const int nth = gridDim.x * tg::kThreads;
  const int tid = blockIdx.x * tg::kThreads + threadIdx.x;

  for (int u = 0; u < a.U; ++u) {
    const size_t row0 = (size_t)u * d.B;
    if (threadIdx.x == 0) p = plan(d, on, tn, a.obs, a.s_idx + row0, a.n_idx + row0, a.scratch);
    __syncthreads();
    SGA_STAMP(0);
    tg::run_phase(p.l1, p.passes, smem);
    grid.sync();
    SGA_STAMP(1);
    tg::run_phase(p.l2, p.passes, smem);
    grid.sync();
    SGA_STAMP(2);

    // ---- per sample: TD target, Huber, dqs; ∂x2 with the old w3 --------
    for (int b = gwarp; b < d.B; b += warps) {
      const int act = a.act[row0 + b];
      const float* xs = x2 + (size_t)b * d.H2;                // online on s
      const float* xt = x2 + ((size_t)d.B + b) * d.H2;        // target on s'
      const float q_sa = head(xs, on.w3, on.b3, d.H2, d.A, act);
      float boot;
      if (d.dq) {  // the online net picks a* (first max), the target values it
        const float* xn = x2 + (2 * (size_t)d.B + b) * d.H2;
        int astar = 0;
        float m = head(xn, on.w3, on.b3, d.H2, d.A, 0);
        for (int q = 1; q < d.A; ++q) {
          const float v = head(xn, on.w3, on.b3, d.H2, d.A, q);
          if (v > m) m = v, astar = q;
        }
        boot = head(xt, tn.w3, tn.b3, d.H2, d.A, astar);
      } else {
        boot = head(xt, tn.w3, tn.b3, d.H2, d.A, 0);
        for (int q = 1; q < d.A; ++q) boot = fmaxf(boot, head(xt, tn.w3, tn.b3, d.H2, d.A, q));
      }
      const float target =
          __fadd_rn(a.rew[row0 + b], __fmul_rn(a.gamma_n, a.done[row0 + b] ? 0.f : boot));
      const float diff = __fsub_rn(q_sa, target);
      const float ad = fabsf(diff);
      const float quad = fminf(ad, 1.f);
      const float hub = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, quad), quad), __fsub_rn(ad, quad));
      const float dqs = __fmul_rn(fminf(fmaxf(diff, -1.f), 1.f), inv_b);
      float* row = dqb + (size_t)b * d.A;
      for (int q = lane; q < d.A; q += 32) row[q] = q == act ? dqs : 0.f;
      if (lane == 0) hubs[b] = hub;
      float* gr = g2 + (size_t)b * d.H2;
      for (int h = lane; h < d.H2; h += 32)
        gr[h] = xs[h] > 0.f ? __fmul_rn(dqs, on.w3[(size_t)h * d.A + act]) : 0.f;
    }
    grid.sync();
    SGA_STAMP(3);
    tg::run_phase(p.bwd, 3, smem);
    grid.sync();
    SGA_STAMP(4);
    tg::run_phase(p.gw1, 1, smem);
    grid.sync();
    SGA_STAMP(5);

    // ---- join the parts; Adam; the scheduled target sync ---------------
    Adam k;
    const float t = (float)(c0 + u + 1);
    k.b1 = a.beta1;
    k.omb1 = a.omb1;
    k.b2 = a.beta2;
    k.omb2 = a.omb2;
    k.c1 = __fsub_rn(1.f, powf(a.beta1, t));
    k.c2 = __fsub_rn(1.f, powf(a.beta2, t));
    k.eps = a.eps;
    k.neglr = -a.lr;
    const bool sync = (n0 + u + 1) % a.sync_every == 0;
    if (gwarp == warps - 1) {  // the loss: lane l sums samples l, l + 32, ... in order
      float s = 0.f;
      for (int b = lane; b < d.B; b += 32) s = __fadd_rn(s, hubs[b]);
      s = warp_sum(s);
      if (lane == 0) *loss = __fadd_rn(u == 0 ? 0.f : *loss, __fmul_rn(s, inv_b));
    }
    for (int q = 0; q < 3; ++q) {
      const tg::Job& j = q == 0 ? p.bwd[1] : q == 1 ? p.bwd[2] : p.gw1[0];
      const int n_el = j.M * j.N;  // < 2^31: the parameters' 32-bit limit (route)
      for (int e = tid; e < n_el; e += nth) {
        const int m = e / j.N, n = e % j.N;
        // The parameter (offset into a set) each element of the product is.
        size_t at;
        if (q == 0) {  // [gw3; gb3]
          at = (on.w3 - on.w1) + (size_t)m * d.A + n;  // b3 follows w3's last row
        } else if (q == 1) {  // [gw2; gb2]
          at = m < d.H1 ? (on.w2 - on.w1) + (size_t)m * d.H2 + n : (on.b2 - on.w1) + n;
        } else {  // [gw1; gb1]
          at = m < d.D ? (size_t)m * d.H1 + n : (on.b1 - on.w1) + n;
        }
        const float np = adam_step(on.w1, mu.w1, nu.w1, at, tg::join(j, m, n), k);
        if (sync) tn.w1[at] = np;
      }
    }
    grid.sync();
    SGA_STAMP(6);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.count_o = c0 + a.U;
    *a.upd_o = n0 + a.U;
    *a.loss_o = __fdiv_rn(a.U > 0 ? *loss : 0.f, (float)a.U);
  }
}

}  // namespace

#ifdef SGA_TRACE
// Copies the first n stamps ([update][phase], kStampN a row) to `host`.
extern "C" int dqn_update_grid_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * sizeof(long long));
}
#endif

// The launch's plan for these shapes on a card of n_sm SMs: out = {grid
// blocks, shared-memory bytes of a block's staged chunks, scratch floats,
// jobs}, then
// M, N, K and split-K parts of each job in phase order (layer 1 of each
// pass, layer 2 of each pass, ∂x1, the head's, layer 2's and layer 1's
// gradient products); at most 4 + 4 · 10 values. Mirrored by
// ops/dqn_update_kernel.py::grid_geometry.
extern "C" void dqn_update_grid_geometry(int D, int H1, int H2, int A, int B, int double_q,
                                         int n_sm, long long* out) {
  const Dims d = make_dims(D, H1, H2, A, B, double_q);
  const Net none = {};
  const Plan p = plan(d, none, none, nullptr, nullptr, nullptr, nullptr);
  out[0] = (long long)n_sm * tg::kBlocksPerSm;
  out[1] = (long long)tg::kSmemBytes;
  out[2] = (long long)layout(d).total;
  out[3] = 2 * p.passes + 4;
  long long* o = out + 4;
  for (int q = 0; q < p.passes; ++q, o += 4) tg::report(p.l1[q], o);
  for (int q = 0; q < p.passes; ++q, o += 4) tg::report(p.l2[q], o);
  for (int q = 0; q < 3; ++q, o += 4) tg::report(p.bwd[q], o);
  tg::report(p.gw1[0], o);
}

// Launch on `stream`; returns a CUDA error code (0 on success). `state`
// holds the four parameter sets (params, target, μ, ν) packed back to back,
// P floats each as w1 [D, H1], b1, w2 [H1, H2], b2, w3 [H2, A], b3, and is
// updated in place. Indices must lie in [0, S), actions in [0, A).
// `scratch` holds dqn_update_grid_geometry's scratch floats.
extern "C" int dqn_update_grid_launch(
    const void* obs, int D, int H1, int H2, int A, void* state, const void* count0,
    const void* upd0, const void* s_idx, const void* n_idx, const void* act, const void* rew,
    const void* done, int U, int B, float lr, float gamma_n, float beta1, float omb1,
    float beta2, float omb2, float eps, int sync_every, int double_q, void* scratch,
    void* count_o, void* upd_o, void* loss_o, void* stream) {
  if (B < 1 || U < 0 || A < 1 || D < 1 || H1 < 1 || H2 < 1 || sync_every < 1 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.obs = (const float*)obs;
  a.d = make_dims(D, H1, H2, A, B, double_q);
  a.state = (float*)state;
  a.P = (size_t)D * H1 + H1 + (size_t)H1 * H2 + H2 + (size_t)H2 * A + A;
  a.count0 = (const int64_t*)count0;
  a.upd0 = (const int64_t*)upd0;
  a.s_idx = (const int32_t*)s_idx;
  a.n_idx = (const int32_t*)n_idx;
  a.act = (const int32_t*)act;
  a.rew = (const float*)rew;
  a.done = (const uint8_t*)done;
  a.U = U;
  a.lr = lr;
  a.gamma_n = gamma_n;
  a.beta1 = beta1;
  a.omb1 = omb1;
  a.beta2 = beta2;
  a.omb2 = omb2;
  a.eps = eps;
  a.sync_every = sync_every;
  a.scratch = (float*)scratch;
  a.count_o = (int64_t*)count_o;
  a.upd_o = (int64_t*)upd_o;
  a.loss_o = (float*)loss_o;
  return tg::launch(dqn_update_grid_kernel, a, (cudaStream_t)stream);
}
