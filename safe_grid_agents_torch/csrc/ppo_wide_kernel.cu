// PPO optimize, wide route: every epoch × minibatch update of the
// table-folded actor-critic — forward, clipped surrogate + value + entropy
// loss, its hand-derived backward, global-norm clip, Adam and the refold —
// for U updates in ONE cooperative launch over every SM.
//
// Replaces safe_grid_agents_tpu/ops/ppo_kernel.py::_kernel (launched by
// ppo_optimize_run through pl.pallas_call) for the shapes that the
// persistent design (ppo_kernel.cu) does not take: it pads the hidden
// layers to 128 and the heads to 8 in shared memory, so hidden widths above
// 128 or more than 7 actions come here; ops/ppo_kernel.py::route picks this
// kernel from the shape alone, before the launch. The TPU kernel streams
// each minibatch through ONE core in 1024-lane sub-blocks (its sequential
// grid carries the gradient sums in VMEM) and reads the batch's states
// through a one-hot matmul against the fold foldT = w1ᵀ·Oᵀ. On the card the
// B rows of a minibatch are the parallel dimension.
//
// What bounds it on this card: the island preset at hidden 256 (16 updates
// of 16,384 rows, D = 288) is ~9 GFLOP an update in four products (layer
// 2, ∂x1, gW2 and gw1, 2·B·H·H or 2·B·D·H each): ~55 µs an update of the
// tensor cores' TF32 rate in 3xTF32 (three TF32 products a product), with
// ~70 MB of activations an update that mostly stay in L2. The design
// (tile_gemm.cuh): one persistent block per co-resident slot (two 256-thread
// blocks an SM), the U updates looping inside the kernel with a grid
// barrier between dependent phases, every product cut into 64 × 64 output
// tiles spread over the grid and run on the tensor cores in 3xTF32. Before
// the first update the fold fold[S, H1] = O·w1; then, per update:
//
//   1. x1 = tanh(fold[idx] + b1): layer 1 of the folded net is a row gather;
//   2. x2 = tanh(x1·W2 + b2);
//   3. per row: the heads (logits, value) by a warp, the row's loss and
//      dL/d(logits, value) by one lane (a warp takes up to 32 rows at
//      once), and ∂x2 = (dl·Whᵀ) ⊙ (1 − x2²) by the warp;
//   4. ∂x1 = (∂x2·W2ᵀ) ⊙ (1 − x1²); [gW2; gb2] = [x1; 1]ᵀ·∂x2 and
//      [gWh; gbh] = [x2; 1]ᵀ·dl, each summed over the rows in split-K parts
//      of 512 rows (the bias gradient rides along as a row of ones in A);
//   5. [gw1; gb1] = [O[idx]; 1]ᵀ·∂x1 in the same parts: the fold's gradient
//      Oᵀ·(Σ of ∂x1 by state) taken row by row, which needs no per-state
//      buffer for any S; one warp sums the rows' losses;
//   6. every gradient element's parts joined in part order by ONE thread,
//      which also adds its square into its block's Σg² (a fixed tree);
//   7. the global norm from the block partials in block order (every block
//      the same bits), the clip (optax: g if |g| < max_norm else
//      g/|g|·max_norm), Adam with bias correction 1 − β^(count0 + u + 1);
//   8. the refold with the new w1 (not after the last update).
//
// Every sum has one owner that adds in a fixed order and no float atomics
// are used, so the kernel is reproducible run to run on a card (the grid,
// and with it the order of the norm's block partials, depends only on the
// card). The parameters, Adam's moments and the gradient are flat vectors
// in the agent's ravel order (sorted names); the caller passes the offsets
// of w1, b1, Dense_0 (W2, b2), Dense_1 (the logits head Wl, bl) and Dense_2
// (the value head Wv, bv).
#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

// Phase stamps of update u (tools/trace_learners.py), compiled only with
// -DSGA_TRACE: after each grid barrier, block 0's thread 0 records
// %globaltimer (ns). Without it SGA_STAMP is empty.
#ifdef SGA_TRACE
constexpr int kStampU = 64, kStampN = 16;
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
  int S, D, H1, H2, A, B;
};

// Offsets into the flat parameter (and moment, and gradient) vectors.
struct Offs {
  int w1, b1, w2, b2, wl, bl, wv, bv;
};

// Scratch offsets (floats): the fold [S, H1], x1 and ∂x1 [B, H1], x2 and
// ∂x2 [B, H2], dl [B, A + 1] (dL/d(logits, value)), the rows' losses [B],
// the flat gradient [P], the split-K parts of the three gradient products,
// the running loss and one Σg² a grid block; each buffer starts on a
// 16-byte boundary.
struct Scratch {
  size_t fold, x1, g1, x2, g2, dl, rl, grad, pw2, pwh, pw1, red, total;
};

__host__ __device__ Scratch layout(const Dims& d, int P, int grid) {
  Scratch s;
  const size_t parts = tg::parts(d.B), B = d.B;
  s.fold = 0;
  s.x1 = tg::r4(s.fold + (size_t)d.S * d.H1);
  s.g1 = tg::r4(s.x1 + B * d.H1);
  s.x2 = tg::r4(s.g1 + B * d.H1);
  s.g2 = tg::r4(s.x2 + B * d.H2);
  s.dl = tg::r4(s.g2 + B * d.H2);
  s.rl = tg::r4(s.dl + B * (d.A + 1));
  s.grad = tg::r4(s.rl + B);
  s.pw2 = tg::r4(s.grad + P);
  s.pwh = tg::r4(s.pw2 + parts * (d.H1 + 1) * d.H2);
  s.pw1 = tg::r4(s.pwh + parts * (d.H2 + 1) * (d.A + 1));
  s.red = tg::r4(s.pw1 + parts * (d.D + 1) * d.H1);
  s.total = s.red + 1 + grid;
  return s;
}

// The products of one update (phases 2, 4 and 5) and the refold (phase 8);
// idx is the update's state rows, p the flat parameters.
struct Plan {
  tg::Job l2[1], bwd[3], gw1[1], fold[1];
};

__host__ __device__ Plan plan(const Dims& d, const Offs& o, int P, int grid, const float* p,
                              const float* obs, const int32_t* idx, float* scratch) {
  using namespace tg;
  const Scratch sc = layout(d, P, grid);
  float *x1 = scratch + sc.x1, *g1 = scratch + sc.g1, *x2 = scratch + sc.x2,
        *g2 = scratch + sc.g2;
  Plan q;
  q.l2[0] = job(opnd(x1, d.H1, 0, d.B), opnd(p + o.w2, d.H2, 1, d.H2), d.B, d.H2, d.H1, false,
                kTanhBias, x2, d.H2, p + o.b2);
  // ∂x1 = (∂x2·W2ᵀ) ⊙ (1 − x1²).
  q.bwd[0] = job(opnd(g2, d.H2, 0, d.B), opnd(p + o.w2, d.H2, 0, d.H1), d.B, d.H1, d.H2, false,
                 kTanhMask, g1, d.H1, nullptr, x1);
  // [gW2; gb2] = [x1; 1]ᵀ·∂x2, [gWh; gbh] = [x2; 1]ᵀ·dl.
  q.bwd[1] = job(opnd(x1, d.H1, 1, d.H1, nullptr, d.H1), opnd(g2, d.H2, 1, d.H2), d.H1 + 1,
                 d.H2, d.B, true, kStore, scratch + sc.pw2, d.H2);
  q.bwd[2] = job(opnd(x2, d.H2, 1, d.H2, nullptr, d.H2),
                 opnd(scratch + sc.dl, d.A + 1, 1, d.A + 1), d.H2 + 1, d.A + 1, d.B, true,
                 kStore, scratch + sc.pwh, d.A + 1);
  // [gw1; gb1] = [O[idx]; 1]ᵀ·∂x1.
  q.gw1[0] = job(opnd(obs, d.D, 1, d.D, idx, d.D), opnd(g1, d.H1, 1, d.H1), d.D + 1, d.H1, d.B,
                 true, kStore, scratch + sc.pw1, d.H1);
  // fold = O·w1.
  q.fold[0] = job(opnd(obs, d.D, 0, d.S), opnd(p + o.w1, d.H1, 1, d.H1), d.S, d.H1, d.D, false,
                  kStore, scratch + sc.fold, d.H1);
  return q;
}

// Σ over the warp's lanes, in a fixed butterfly (every lane ends with the
// same bits).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

struct Args {
  const float* obs;
  Dims d;
  Offs o;
  int P;
  float* state;
  const int64_t* count0;
  const float* ce;
  const int32_t* sidx;
  const int32_t* act;
  const float* olp;
  const float* adv;
  const float* ret;
  int U;
  float lr, clip_lo, clip_hi, value_coef, max_norm, beta1, omb1, beta2, omb2, eps;
  float* scratch;
  int64_t* count_o;
  float* loss_o;
};

__global__ void __launch_bounds__(tg::kThreads, tg::kBlocksPerSm)
    ppo_wide_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];  // the copy ring (tg::kSmemFloats)
  __shared__ Plan pl;  // the update's products, built by thread 0
  __shared__ float red_s[tg::kThreads];
  cg::grid_group grid = cg::this_grid();
  const Dims& d = a.d;
  const Offs& o = a.o;
  const int H1 = d.H1, H2 = d.H2, A = d.A, A1 = d.A + 1;
  const Scratch sc = layout(d, a.P, gridDim.x);
  float* p = a.state;
  float* m = p + a.P;
  float* v = m + a.P;
  float* fold = a.scratch + sc.fold;
  float* x1 = a.scratch + sc.x1;
  float* x2 = a.scratch + sc.x2;
  float* g2 = a.scratch + sc.g2;
  float* dl = a.scratch + sc.dl;
  float* rl = a.scratch + sc.rl;
  float* grad = a.scratch + sc.grad;
  float* red = a.scratch + sc.red;  // [0] the running Σ of mean losses, [1 + b] block b's Σg²
  const int64_t c0 = *a.count0;
  const float ce = *a.ce;
  const float inv_b = __fdiv_rn(1.f, (float)d.B);
  const float ce_b = __fmul_rn(ce, inv_b);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (tg::kThreads / 32);
  const int gwarp = blockIdx.x * (tg::kThreads / 32) + (threadIdx.x >> 5);
  const int nth = gridDim.x * tg::kThreads;
  const int tid = blockIdx.x * tg::kThreads + threadIdx.x;
  const float* Wl = p + o.wl;
  const float* Wv = p + o.wv;

  if (threadIdx.x == 0) pl = plan(d, o, a.P, gridDim.x, p, a.obs, a.sidx, a.scratch);
  __syncthreads();
  tg::run_phase(pl.fold, 1, smem);
  grid.sync();
  for (int u = 0; u < a.U; ++u) {
    const size_t row0 = (size_t)u * d.B;
    const int32_t* idx = a.sidx + row0;
    if (threadIdx.x == 0) pl = plan(d, o, a.P, gridDim.x, p, a.obs, idx, a.scratch);
    __syncthreads();
    SGA_STAMP(0);
    // ---- 1. layer 1 from the fold, one warp a row --------------------------
    const float* b1 = p + o.b1;
    for (int r = gwarp; r < d.B; r += warps) {
      const float* f = fold + (size_t)idx[r] * H1;
      float* x = x1 + (size_t)r * H1;
      for (int j = lane; j < H1; j += 32) x[j] = tanhf(__fadd_rn(f[j], b1[j]));
    }
    grid.sync();
    SGA_STAMP(1);
    tg::run_phase(pl.l2, 1, smem);
    grid.sync();
    SGA_STAMP(2);

    // ---- 3. per row: heads, loss, dL/d(logits, value), ∂x2 ----------------
    // A warp takes G rows at a time (up to 32, as many as spread the rows
    // over the grid's warps): their heads (lanes over the hidden units) go
    // to the warp's slot of the (idle) copy ring, lane l works out row l's
    // loss and dL/d(logits, value) there, and the lanes write the rows' ∂x2
    // and copy the slot to dl. Heads wider than a slot work in dl, one row
    // at a time.
    constexpr int kSlot = tg::kSmemFloats / (tg::kThreads / 32);
    float* slot = smem + (threadIdx.x >> 5) * kSlot;
    const bool in_slot = A1 <= kSlot;
    const int G = in_slot ? max(1, min(min(32, kSlot / A1), tg::cdiv(d.B, warps))) : 1;
    for (int r0 = gwarp * G; r0 < d.B; r0 += warps * G) {
      const int rows = min(G, d.B - r0);
      float* ys = in_slot ? slot : dl + (size_t)r0 * A1;  // the rows' heads, A1 apart
      for (int i = 0; i < rows; ++i) {
        const float* x = x2 + (size_t)(r0 + i) * H2;
        for (int q = 0; q < A1; ++q) {
          float acc = 0.f;
          for (int k = lane; k < H2; k += 32)
            acc = fmaf(x[k], q < A ? Wl[(size_t)k * A + q] : Wv[k], acc);
          acc = warp_sum(acc);
          if (lane == 0) ys[i * A1 + q] = __fadd_rn(acc, q < A ? p[o.bl + q] : p[o.bv]);
        }
      }
      __syncwarp();
      if (lane < rows) {  // ppo_kernel.py:127-175
        const int r = r0 + lane;
        float* y = ys + lane * A1;
        const size_t at = row0 + r;
        const int act = a.act[at];
        float mx = y[0];
        for (int q = 1; q < A; ++q) mx = fmaxf(mx, y[q]);
        float z = 0.f;
        for (int q = 0; q < A; ++q) z = __fadd_rn(z, expf(__fsub_rn(y[q], mx)));
        const float log_z = __fadd_rn(mx, logf(z));
        float ent = 0.f, lpa = 0.f;
        for (int q = 0; q < A; ++q) {
          const float lp = __fsub_rn(y[q], log_z);
          ent = __fsub_rn(ent, __fmul_rn(expf(lp), lp));
          if (q == act) lpa = lp;
        }
        const float ratio = expf(__fsub_rn(lpa, a.olp[at]));
        const float clip_r = fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
        const float av = a.adv[at];
        const float surr1 = __fmul_rn(ratio, av);
        const float surr2 = __fmul_rn(clip_r, av);
        const float diff = __fsub_rn(y[A], a.ret[at]);
        rl[r] = __fsub_rn(
            __fadd_rn(-fminf(surr1, surr2),
                      __fmul_rn(__fmul_rn(a.value_coef, 0.5f), __fmul_rn(diff, diff))),
            __fmul_rn(ce, ent));
        const bool in_band = ratio >= a.clip_lo && ratio <= a.clip_hi;
        const float active = (surr1 <= surr2 || in_band) ? 1.f : 0.f;
        const float dlogp = -__fmul_rn(__fmul_rn(inv_b, active), __fmul_rn(ratio, av));
        for (int q = 0; q < A; ++q) {
          const float lp = __fsub_rn(y[q], log_z);
          const float pa = expf(lp);
          const float onehot = q == act ? 1.f : 0.f;
          y[q] = __fadd_rn(__fmul_rn(dlogp, __fsub_rn(onehot, pa)),
                           __fmul_rn(ce_b, __fmul_rn(pa, __fadd_rn(lp, ent))));
        }
        y[A] = __fmul_rn(__fmul_rn(a.value_coef, inv_b), diff);
      }
      __syncwarp();
      for (int i = 0; i < rows; ++i) {
        const float* x = x2 + (size_t)(r0 + i) * H2;
        const float* y = ys + i * A1;
        for (int k = lane; k < H2; k += 32) {
          float acc = 0.f;
          for (int q = 0; q < A; ++q) acc = fmaf(y[q], Wl[(size_t)k * A + q], acc);
          acc = fmaf(y[A], Wv[k], acc);
          g2[(size_t)(r0 + i) * H2 + k] = __fmul_rn(acc, __fsub_rn(1.f, __fmul_rn(x[k], x[k])));
        }
      }
      if (in_slot)
        for (int q = lane; q < rows * A1; q += 32) dl[(size_t)r0 * A1 + q] = ys[q];
      __syncwarp();  // the slot is read before the next rows overwrite it
    }
    grid.sync();
    SGA_STAMP(3);
    tg::run_phase(pl.bwd, 3, smem);
    grid.sync();
    SGA_STAMP(4);
    tg::run_phase(pl.gw1, 1, smem);
    if (gwarp == warps - 1) {  // the loss: lane l sums rows l, l + 32, ... in order
      float s = 0.f;
      for (int r = lane; r < d.B; r += 32) s = __fadd_rn(s, rl[r]);
      s = warp_sum(s);
      if (lane == 0) red[0] = __fadd_rn(u == 0 ? 0.f : red[0], __fdiv_rn(s, (float)d.B));
    }
    grid.sync();
    SGA_STAMP(5);

    // ---- 6. join the parts into the flat gradient; Σg² a block -------------
    float ss = 0.f;
    for (int q = 0; q < 3; ++q) {
      const tg::Job& j = q == 0 ? pl.bwd[1] : q == 1 ? pl.bwd[2] : pl.gw1[0];
      const int n_el = j.M * j.N;  // < 2^31: the parameters' 32-bit limit (route)
      for (int e = tid; e < n_el; e += nth) {
        const int mm = e / j.N, n = e % j.N;
        size_t at;
        if (q == 0) {  // [gW2; gb2]
          at = mm < H1 ? (size_t)o.w2 + (size_t)mm * H2 + n : (size_t)o.b2 + n;
        } else if (q == 1) {  // [gWl, gWv; gbl, gbv]
          if (mm < H2) at = n < A ? (size_t)o.wl + (size_t)mm * A + n : (size_t)o.wv + mm;
          else at = n < A ? (size_t)o.bl + n : (size_t)o.bv;
        } else {  // [gw1; gb1]
          at = mm < d.D ? (size_t)o.w1 + (size_t)mm * H1 + n : (size_t)o.b1 + n;
        }
        const float g = tg::join(j, mm, n);
        grad[at] = g;
        ss = fmaf(g, g, ss);
      }
    }
    red_s[threadIdx.x] = ss;
    __syncthreads();
    for (int w = tg::kThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) red_s[threadIdx.x] = __fadd_rn(red_s[threadIdx.x], red_s[threadIdx.x + w]);
      __syncthreads();
    }
    if (threadIdx.x == 0) red[1 + blockIdx.x] = red_s[0];
    grid.sync();
    SGA_STAMP(6);

    // ---- 7. the norm (block partials in block order), clip, Adam -----------
    if (threadIdx.x < 32) {
      float s = 0.f;
      for (int c = threadIdx.x; c < (int)gridDim.x; c += 32) s = __fadd_rn(s, red[1 + c]);
      s = warp_sum(s);
      if (threadIdx.x == 0) red_s[0] = __fsqrt_rn(s);
    }
    __syncthreads();
    const float gn = red_s[0];
    const float t = (float)(c0 + u + 1);
    const float c1 = __fsub_rn(1.f, powf(a.beta1, t));
    const float c2 = __fsub_rn(1.f, powf(a.beta2, t));
    for (int i = tid; i < a.P; i += nth) {
      float g = grad[i];
      if (!(gn < a.max_norm)) g = __fmul_rn(__fdiv_rn(g, gn), a.max_norm);
      const float mm = __fadd_rn(__fmul_rn(a.omb1, g), __fmul_rn(a.beta1, m[i]));
      const float vv = __fadd_rn(__fmul_rn(a.omb2, __fmul_rn(g, g)), __fmul_rn(a.beta2, v[i]));
      m[i] = mm;
      v[i] = vv;
      const float upd =
          __fdiv_rn(__fdiv_rn(mm, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, c2)), a.eps));
      p[i] = __fadd_rn(p[i], __fmul_rn(-a.lr, upd));
    }
    grid.sync();
    SGA_STAMP(7);
    if (u + 1 < a.U) {  // ---- 8. the refold for the next update ----------------
      tg::run_phase(pl.fold, 1, smem);
      grid.sync();
      SGA_STAMP(8);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.loss_o = __fdiv_rn(red[0], (float)a.U);
    *a.count_o = c0 + a.U;
  }
}

Dims make_dims(int S, int D, int H1, int H2, int A, int B) {
  Dims d;
  d.S = S;
  d.D = D;
  d.H1 = H1;
  d.H2 = H2;
  d.A = A;
  d.B = B;
  return d;
}

}  // namespace

#ifdef SGA_TRACE
// Copies the first n stamps ([update][phase], kStampN a row) to `host`.
extern "C" int ppo_wide_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * sizeof(long long));
}
#endif

// The launch's plan for these shapes on a card of n_sm SMs: out = {grid
// blocks, shared-memory bytes of a block's staged chunks, scratch floats,
// jobs (6)},
// then M, N, K and split-K parts of the fold, layer 2, ∂x1, [gW2; gb2],
// [gWh; gbh] and [gw1; gb1]. Mirrored by ops/ppo_kernel.py::wide_geometry.
extern "C" void ppo_wide_geometry(int S, int D, int H1, int H2, int A, int P, int B, int n_sm,
                                  long long* out) {
  const Dims d = make_dims(S, D, H1, H2, A, B);
  const int grid = n_sm * tg::kBlocksPerSm;
  const Plan q = plan(d, Offs{}, P, grid, nullptr, nullptr, nullptr, nullptr);
  out[0] = grid;
  out[1] = (long long)tg::kSmemBytes;
  out[2] = (long long)layout(d, P, grid).total;
  out[3] = 6;
  tg::report(q.fold[0], out + 4);
  tg::report(q.l2[0], out + 8);
  for (int i = 0; i < 3; ++i) tg::report(q.bwd[i], out + 12 + 4 * i);
  tg::report(q.gw1[0], out + 24);
}

// Launch on `stream`; returns a CUDA error code (0 on success). `scratch`
// holds the floats ppo_wide_geometry gives. `state` holds the flat params,
// μ and ν back to back (P floats each) and is updated in place; `offs`
// (host memory) gives the offsets of w1, b1, W2, b2, Wl, bl, Wv, bv in the
// flat layout. Streams are [U, B]: state index, action, old logp,
// advantage, return. `ce` is a device f32 scalar (the entropy coefficient),
// `count0` a device int64 (Adam steps so far).
extern "C" int ppo_wide_launch(
    const void* obs, int S, int D, int H1, int H2, int A, const int* offs,
    int P, void* state, const void* count0, const void* ce,
    const void* sidx, const void* act, const void* olp, const void* adv,
    const void* ret, int U, int B, float lr, float clip_lo, float clip_hi,
    float value_coef, float max_norm, float beta1, float omb1, float beta2,
    float omb2, float eps, void* scratch, void* count_o, void* loss_o,
    void* stream) {
  if (B < 1 || U < 1 || A < 2 || S < 1 || D < 1 || H1 < 1 || H2 < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.obs = (const float*)obs;
  a.d = make_dims(S, D, H1, H2, A, B);
  a.o.w1 = offs[0];
  a.o.b1 = offs[1];
  a.o.w2 = offs[2];
  a.o.b2 = offs[3];
  a.o.wl = offs[4];
  a.o.bl = offs[5];
  a.o.wv = offs[6];
  a.o.bv = offs[7];
  a.P = P;
  a.state = (float*)state;
  a.count0 = (const int64_t*)count0;
  a.ce = (const float*)ce;
  a.sidx = (const int32_t*)sidx;
  a.act = (const int32_t*)act;
  a.olp = (const float*)olp;
  a.adv = (const float*)adv;
  a.ret = (const float*)ret;
  a.U = U;
  a.lr = lr;
  a.clip_lo = clip_lo;
  a.clip_hi = clip_hi;
  a.value_coef = value_coef;
  a.max_norm = max_norm;
  a.beta1 = beta1;
  a.omb1 = omb1;
  a.beta2 = beta2;
  a.omb2 = omb2;
  a.eps = eps;
  a.scratch = (float*)scratch;
  a.count_o = (int64_t*)count_o;
  a.loss_o = (float*)loss_o;
  return tg::launch(ppo_wide_kernel, a, (cudaStream_t)stream);
}
