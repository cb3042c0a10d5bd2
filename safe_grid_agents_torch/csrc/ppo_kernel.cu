// PPO optimize: every epoch × minibatch update of the table-folded
// actor-critic — forward, clipped surrogate + value + entropy loss, its
// hand-derived backward, global-norm clip, Adam and the refold — for U
// updates in one C entry point on one stream.
//
// Replaces safe_grid_agents_tpu/ops/ppo_kernel.py::_kernel (launched by
// ppo_optimize_run through pl.pallas_call). The TPU kernel streams each
// minibatch through ONE core in 1024-lane sub-blocks (its sequential grid
// carries the gradient sums in VMEM) and reads the batch's states through
// a one-hot matmul against the fold foldT = w1ᵀ·Oᵀ. On the card the B rows
// of a minibatch are the parallel dimension. One call is 1 + 2U launches:
//
//   0. fold     fold[S, H1] = O·w1, before the first update;
//   per update:
//   1. grad     persistent: one block per SM walks a fixed stripe of 64-row
//               tiles. Per tile it gathers fold[idx] for layer 1 and runs
//               the forward, the per-row loss and dL/d(logits, value), and
//               the backward, with W2 staged once in shared memory and the
//               three 64 × 128 × 128 products (x1·W2, ∂x2·W2ᵀ, x1ᵀ·∂x2) in
//               register tiles; the block's gW2 sum stays in registers over
//               its stripe, its gfold, bias and head sums in shared memory,
//               and it writes ONE partial record at the end (≤ 132 records);
//   2. finish   cooperative (up to four blocks per SM, grid barriers): sums
//               the partial records in block order, gw1 = Oᵀ·gfold, the
//               global norm (block partials of Σg² summed in block order),
//               the clip (optax: g if |g| < max_norm else g/|g|·max_norm),
//               Adam with bias correction 1 − β^(count0 + u + 1), and the
//               refold; each long sum split over 4–8 lanes of a warp and
//               joined in a fixed butterfly.
//
// What bounds it on this card: the island preset (16 updates of 16,384
// rows, D = 288, H = 128) does ~14 G float multiply-adds, ~0.4 ms at the
// float32 rate outside the tensor cores. The first design spent 81% of its
// 7.8 ms in a grad kernel of 256 blocks that re-read W2 through L1/L2 with
// one 64-row block per 8 warps, and paid six launches per update. Here the
// grad kernel's inner products run from shared memory at 128 FMAs per 12
// 16-byte loads (x1·W2, ∂x2·W2ᵀ) and 64 per 4 (x1ᵀ·∂x2), and an update is
// two launches.
//
// Every sum runs in a fixed order and no float atomics are used, so the
// kernel is reproducible run to run on a card (the finish grid's size, and
// with it the order of the norm's block partials, depends only on the card). The parameters, Adam's moments and the gradient are flat
// vectors in the agent's ravel order (sorted names); the caller passes the
// offsets of w1, b1, Dense_0 (W2, b2), Dense_1 (the logits head Wl, bl)
// and Dense_2 (the value head Wv, bv). Hidden widths up to 128 (zero-padded
// to 128 in shared memory, which leaves every sum exact) and A ≤ 7.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Phase stamps of update u (tools/trace_learners.py), compiled only with
// -DSGA_TRACE: a block barrier, then block 0's thread 0 records
// %globaltimer (ns; one clock for both kernels). Without it SGA_STAMP is
// empty and the kernels are unchanged.
#ifdef SGA_TRACE
constexpr int kStampU = 64, kStampN = 32;
__device__ long long g_stamps[kStampU * kStampN];
__device__ __forceinline__ long long sga_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SGA_STAMP(i)                                          \
  do {                                                        \
    __syncthreads();                                          \
    if (threadIdx.x == 0 && blockIdx.x == 0 && u < kStampU)   \
      g_stamps[u * kStampN + (i)] = sga_now();                \
  } while (0)
#else
#define SGA_STAMP(i) \
  do {               \
  } while (0)
#endif

constexpr int kThreads = 256;
constexpr int kR = 64;               // rows per tile
constexpr int kHP = 128;             // hidden width, padded
constexpr int kLD = kHP + 4;         // row stride of x1, x2, W2 and the heads in shared memory
constexpr int kA1P = 8;              // logits + value, padded
constexpr int kMaxFinish = 1024;     // finish blocks at most (norm partials)
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap
static_assert(kThreads == 2 * kHP, "the head and ∂x2 stages map two threads to a unit");

struct Dims {
  int S, D, H1, H2, A, B;
};

// Offsets into the flat parameter (and moment, and gradient) vectors.
struct Offs {
  int w1, b1, w2, b2, wl, bl, wv, bv;
};

// Layout of one block's partial record (floats).
struct Part {
  int gf, w2, b2, wl, wv, bl, bv, b1, loss, G;
};

__host__ __device__ Part part_layout(const Dims& d) {
  Part p;
  p.gf = 0;
  p.w2 = d.S * d.H1;
  p.b2 = p.w2 + d.H1 * d.H2;
  p.wl = p.b2 + d.H2;
  p.wv = p.wl + d.H2 * d.A;
  p.bl = p.wv + d.H2;
  p.bv = p.bl + d.A;
  p.b1 = p.bv + 1;
  p.loss = p.b1 + d.H1;
  p.G = p.loss + 1;
  return p;
}

// Launch geometry, mirrored by ops/ppo_kernel.py::geometry.
struct Geo {
  int tiles, tpb, grid;  // 64-row tiles, tiles per block (the stripe), grad blocks
  int gf_smem;           // gfold partial in shared memory (else in the record)
  size_t smem;           // grad kernel's dynamic shared memory, bytes
};

// Grad kernel's shared memory without the gfold buffer (floats): W2, the
// heads (transposed), b1, b2, bh; x1, x2; dl, row losses, the five streams;
// the head, bias and loss accumulators.
constexpr size_t grad_smem_floats() {
  return (size_t)kHP * kLD + kA1P * kLD + 2 * kHP + kA1P + 2 * (size_t)kR * kLD +
         kR * kA1P + kR + 5 * kR + (kHP * kA1P + kA1P + 2 * kHP + 4);
}

Geo make_geo(const Dims& d, int n_sm) {
  Geo g;
  g.tiles = (d.B + kR - 1) / kR;
  g.tpb = (g.tiles + n_sm - 1) / n_sm;
  g.grid = (g.tiles + g.tpb - 1) / g.tpb;
  const size_t base = grad_smem_floats() * 4, gf = (size_t)d.S * d.H1 * 4;
  g.gf_smem = base + gf <= kMaxSmem ? 1 : 0;
  g.smem = base + (g.gf_smem ? gf : 0);
  return g;
}

__global__ void fold_kernel(const float* __restrict__ obs,
                            const float* __restrict__ p, Offs o, Dims d,
                            float* __restrict__ fold) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d.S * d.H1) return;
  const int s = i / d.H1, j = i % d.H1;
  const float* w1 = p + o.w1;
  float acc = 0.f;
  for (int k = 0; k < d.D; ++k)
    acc = fmaf(obs[(size_t)s * d.D + k], w1[(size_t)k * d.H1 + j], acc);
  fold[i] = acc;
}

__global__ void __launch_bounds__(kThreads, 1) grad_kernel(
    const float* __restrict__ p, Offs o, Dims d, int tpb, int gf_smem,
    const float* __restrict__ fold, const int32_t* __restrict__ sidx,
    const int32_t* __restrict__ act, const float* __restrict__ olp,
    const float* __restrict__ adv, const float* __restrict__ ret, int u,
    const float* __restrict__ ce_p, float clip_lo, float clip_hi,
    float value_coef, float* __restrict__ partials) {
  const int H1 = d.H1, H2 = d.H2, A = d.A, A1 = d.A + 1;
  const Part pl = part_layout(d);
  extern __shared__ __align__(16) float smem[];
  float* W2 = smem;                  // [kHP][kLD], W2[j][k], zero-padded
  float* WhT = W2 + kHP * kLD;       // [kA1P][kLD], WhT[a][k]: Wl then Wv
  float* b1 = WhT + kA1P * kLD;      // [kHP]
  float* b2 = b1 + kHP;              // [kHP]
  float* bh = b2 + kHP;              // [kA1P]: bl then bv
  float* x1 = bh + kA1P;             // [kR][kLD] x1, then ∂(pre-activation 1)
  float* x2 = x1 + kR * kLD;         // [kR][kLD] x2, then ∂(pre-activation 2)
  float* dl = x2 + kR * kLD;         // [kR][kA1P] head output, then dL/d(logits, value)
  float* rl = dl + kR * kA1P;        // [kR] row losses
  int32_t* s_idx = reinterpret_cast<int32_t*>(rl + kR);
  int32_t* s_act = s_idx + kR;
  float* s_olp = reinterpret_cast<float*>(s_act + kR);
  float* s_adv = s_olp + kR;
  float* s_ret = s_adv + kR;
  float* aWh = s_ret + kR;           // [kHP][kA1P] Σ x2·dl
  float* abh = aWh + kHP * kA1P;     // [kA1P]
  float* ab2 = abh + kA1P;           // [kHP]
  float* ab1 = ab2 + kHP;            // [kHP]
  float* aloss = ab1 + kHP;          // [4]
  float* part = partials + (size_t)blockIdx.x * pl.G;
  float* gf = gf_smem ? aloss + 4 : part + pl.gf;  // [S, H1] gfold partial

  SGA_STAMP(0);
  // ---- stage the weights (zero-padded) and clear the accumulators --------
  // Eight loads in flight a thread.
  for (int i0 = threadIdx.x; i0 < kHP * kLD; i0 += 8 * blockDim.x) {
    float w[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + q * blockDim.x, j = i / kLD, k = i % kLD;
      w[q] = (i < kHP * kLD && j < H1 && k < H2) ? p[o.w2 + j * H2 + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + q * blockDim.x;
      if (i < kHP * kLD) W2[i] = w[q];
    }
  }
  for (int i = threadIdx.x; i < kA1P * kLD; i += blockDim.x) {
    const int a = i / kLD, k = i % kLD;
    float w = 0.f;
    if (k < H2 && a < A) w = p[o.wl + k * A + a];
    else if (k < H2 && a == A) w = p[o.wv + k];
    WhT[i] = w;
  }
  for (int i = threadIdx.x; i < kHP; i += blockDim.x) {
    b1[i] = i < H1 ? p[o.b1 + i] : 0.f;
    b2[i] = i < H2 ? p[o.b2 + i] : 0.f;
  }
  for (int a = threadIdx.x; a < kA1P; a += blockDim.x)
    bh[a] = a < A ? p[o.bl + a] : a == A ? p[o.bv] : 0.f;
  for (int i = threadIdx.x; i < kHP * kA1P + kA1P + 2 * kHP + 4; i += blockDim.x) aWh[i] = 0.f;
  for (int c = threadIdx.x; c < d.S * H1; c += blockDim.x) gf[c] = 0.f;

  // Register tiles: rows rg·4 + i; columns cg·4 + q and 64 + cg·4 + q.
  const int rg = threadIdx.x / 16, cg16 = threadIdx.x % 16;
  float gw2[8][8];  // Σ x1ᵀ·∂x2 over the stripe: j = rg·4+(0..3), 64+rg·4+(0..3)
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) gw2[a][b] = 0.f;

  const float ce = *ce_p;
  const float inv_b = __fdiv_rn(1.f, (float)d.B);
  const int tile0 = blockIdx.x * tpb;
  const int tile1 = min(tile0 + tpb, (d.B + kR - 1) / kR);
  __syncthreads();

  for (int tile = tile0; tile < tile1; ++tile) {
    const int row0 = tile * kR;
    const int rows = min(kR, d.B - row0);
    if (tile == tile0) SGA_STAMP(1);
    for (int r = threadIdx.x; r < kR; r += blockDim.x) {
      const size_t at = (size_t)u * d.B + row0 + r;
      const bool live = r < rows;
      s_idx[r] = live ? sidx[at] : 0;
      s_act[r] = live ? act[at] : 0;
      s_olp[r] = live ? olp[at] : 0.f;
      s_adv[r] = live ? adv[at] : 0.f;
      s_ret[r] = live ? ret[at] : 0.f;
    }
    __syncthreads();

    if (tile == tile0) SGA_STAMP(2);
    // ---- forward ------------------------------------------------------
    // Layer 1 from the fold: x1 = tanh(fold[idx] + b1), 0 in the pad;
    // eight loads in flight a thread.
    for (int c0 = threadIdx.x; c0 < kR * kHP; c0 += 8 * blockDim.x) {
      float f[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = c0 + q * blockDim.x, j = c % kHP;
        f[q] = (c < kR * kHP && j < H1) ? fold[(size_t)s_idx[c / kHP] * H1 + j] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = c0 + q * blockDim.x, j = c % kHP;
        if (c < kR * kHP) x1[(c / kHP) * kLD + j] = j < H1 ? tanhf(__fadd_rn(f[q], b1[j])) : 0.f;
      }
    }
    __syncthreads();
    if (tile == tile0) SGA_STAMP(3);
    // Layer 2: x2 = tanh(x1·W2 + b2), 4 rows × 8 columns a thread.
    {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
      for (int k = 0; k < kHP; k += 4) {
        float4 xr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xr[i] = *reinterpret_cast<const float4*>(x1 + (rg * 4 + i) * kLD + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 wa = *reinterpret_cast<const float4*>(W2 + (k + q) * kLD + cg16 * 4);
          const float4 wb =
              *reinterpret_cast<const float4*>(W2 + (k + q) * kLD + 64 + cg16 * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = q == 0 ? xr[i].x : q == 1 ? xr[i].y : q == 2 ? xr[i].z : xr[i].w;
            acc[i][0] = fmaf(x, wa.x, acc[i][0]);
            acc[i][1] = fmaf(x, wa.y, acc[i][1]);
            acc[i][2] = fmaf(x, wa.z, acc[i][2]);
            acc[i][3] = fmaf(x, wa.w, acc[i][3]);
            acc[i][4] = fmaf(x, wb.x, acc[i][4]);
            acc[i][5] = fmaf(x, wb.y, acc[i][5]);
            acc[i][6] = fmaf(x, wb.z, acc[i][6]);
            acc[i][7] = fmaf(x, wb.w, acc[i][7]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = (c < 4 ? 0 : 64) + cg16 * 4 + (c & 3);
          x2[(rg * 4 + i) * kLD + n] = tanhf(__fadd_rn(acc[i][c], b2[n]));
        }
    }
    __syncthreads();
    if (tile == tile0) SGA_STAMP(4);
    // Heads: y[r, a] = x2·Wl + bl (a < A), y[r, A] = x2·Wv + bv; four
    // running sums (k mod 4) joined in a fixed order.
    for (int c = threadIdx.x; c < kR * A1; c += blockDim.x) {
      const int r = c / A1, a = c % A1;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < kHP; k += 4) {
        const float4 x = *reinterpret_cast<const float4*>(x2 + r * kLD + k);
        const float4 w = *reinterpret_cast<const float4*>(WhT + a * kLD + k);
        acc[0] = fmaf(x.x, w.x, acc[0]);
        acc[1] = fmaf(x.y, w.y, acc[1]);
        acc[2] = fmaf(x.z, w.z, acc[2]);
        acc[3] = fmaf(x.w, w.w, acc[3]);
      }
      dl[r * kA1P + a] = __fadd_rn(
          __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])), bh[a]);
    }
    __syncthreads();

    if (tile == tile0) SGA_STAMP(5);
    // ---- per row: loss and dL/d(logits, value) (ppo_kernel.py:127-175) ---
    for (int r = threadIdx.x; r < kR; r += blockDim.x) {
      float* y = dl + r * kA1P;
      if (r >= rows) {
        for (int a = 0; a < A1; ++a) y[a] = 0.f;
        rl[r] = 0.f;
        continue;
      }
      float m = y[0];
      for (int a = 1; a < A; ++a) m = fmaxf(m, y[a]);
      float z = 0.f;
      for (int a = 0; a < A; ++a) z = __fadd_rn(z, expf(__fsub_rn(y[a], m)));
      const float log_z = __fadd_rn(m, logf(z));
      float ent = 0.f, lpa = 0.f;
      for (int a = 0; a < A; ++a) {
        const float lp = __fsub_rn(y[a], log_z);
        ent = __fsub_rn(ent, __fmul_rn(expf(lp), lp));
        if (a == s_act[r]) lpa = lp;
      }
      const float ratio = expf(__fsub_rn(lpa, s_olp[r]));
      const float clip_r = fminf(fmaxf(ratio, clip_lo), clip_hi);
      const float av = s_adv[r];
      const float surr1 = __fmul_rn(ratio, av);
      const float surr2 = __fmul_rn(clip_r, av);
      const float diff = __fsub_rn(y[A], s_ret[r]);
      rl[r] = __fsub_rn(
          __fadd_rn(-fminf(surr1, surr2),
                    __fmul_rn(__fmul_rn(value_coef, 0.5f), __fmul_rn(diff, diff))),
          __fmul_rn(ce, ent));
      const bool in_band = ratio >= clip_lo && ratio <= clip_hi;
      const float active = (surr1 <= surr2 || in_band) ? 1.f : 0.f;
      const float dlogp = -__fmul_rn(__fmul_rn(inv_b, active), __fmul_rn(ratio, av));
      const float ce_b = __fmul_rn(ce, inv_b);
      for (int a = 0; a < A; ++a) {
        const float lp = __fsub_rn(y[a], log_z);
        const float pa = expf(lp);
        const float onehot = a == s_act[r] ? 1.f : 0.f;
        y[a] = __fadd_rn(__fmul_rn(dlogp, __fsub_rn(onehot, pa)),
                         __fmul_rn(ce_b, __fmul_rn(pa, __fadd_rn(lp, ent))));
      }
      y[A] = __fmul_rn(__fmul_rn(value_coef, inv_b), diff);
    }
    __syncthreads();

    if (tile == tile0) SGA_STAMP(6);
    // ---- head sums over the tile's rows, in order: thread (k, h) keeps head
    // columns 4h .. 4h+3 of hidden unit k (kThreads = 2·kHP, A + 1 ≤ 8) ----
    {
      const int k = threadIdx.x % kHP, a0 = (threadIdx.x / kHP) * 4;
      if (k < H2 && a0 < A1) {
        float acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = aWh[k * kA1P + a0 + q];
        for (int r = 0; r < rows; ++r) {
          const float x = x2[r * kLD + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(x, dl[r * kA1P + a0 + q], acc[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (a0 + q < A1) aWh[k * kA1P + a0 + q] = acc[q];
      }
      for (int a = threadIdx.x; a < A1; a += blockDim.x) {
        float acc = abh[a];
        for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, dl[r * kA1P + a]);
        abh[a] = acc;
      }
    }
    __syncthreads();
    if (tile == tile0) SGA_STAMP(7);
    // ∂x2 = (dl·Whᵀ) ⊙ (1 − x2²), in place of x2 (0 in the pad); thread
    // (k, h) keeps column k of the heads in registers and takes rows h, h+2, ...
    {
      const int k = threadIdx.x % kHP;
      float w[kA1P];
#pragma unroll
      for (int a = 0; a < kA1P; ++a) w[a] = a < A1 ? WhT[a * kLD + k] : 0.f;
#pragma unroll 4
      for (int r = threadIdx.x / kHP; r < kR; r += kThreads / kHP) {
        const float* y = dl + r * kA1P;
        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < kA1P; ++a)
          if (a < A1) acc = fmaf(y[a], w[a], acc);
        const float x = x2[r * kLD + k];
        x2[r * kLD + k] = __fmul_rn(acc, __fsub_rn(1.f, __fmul_rn(x, x)));
      }
    }
    __syncthreads();
    if (tile == tile0) SGA_STAMP(8);
    // gb2 and gW2 += x1ᵀ·∂x2 (registers: j = rg·4 + .., k = cg·4 + ..).
    for (int k = threadIdx.x; k < H2; k += blockDim.x) {
      float acc = ab2[k];
      for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, x2[r * kLD + k]);
      ab2[k] = acc;
    }
    for (int r = 0; r < rows; ++r) {
      const float4 xa = *reinterpret_cast<const float4*>(x1 + r * kLD + rg * 4);
      const float4 xb = *reinterpret_cast<const float4*>(x1 + r * kLD + 64 + rg * 4);
      const float4 ga = *reinterpret_cast<const float4*>(x2 + r * kLD + cg16 * 4);
      const float4 gb = *reinterpret_cast<const float4*>(x2 + r * kLD + 64 + cg16 * 4);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) gw2[a][b] = fmaf(xv[a], gv[b], gw2[a][b]);
    }
    __syncthreads();
    if (tile == tile0) SGA_STAMP(9);
    // ∂x1 = (∂x2·W2ᵀ) ⊙ (1 − x1²), in place of x1; j = cg + 16·c.
    {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
      for (int k = 0; k < kHP; k += 4) {
        float4 gr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          gr[i] = *reinterpret_cast<const float4*>(x2 + (rg * 4 + i) * kLD + k);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 w = *reinterpret_cast<const float4*>(W2 + (cg16 + 16 * c) * kLD + k);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c] = fmaf(gr[i].x, w.x, acc[i][c]);
            acc[i][c] = fmaf(gr[i].y, w.y, acc[i][c]);
            acc[i][c] = fmaf(gr[i].z, w.z, acc[i][c]);
            acc[i][c] = fmaf(gr[i].w, w.w, acc[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float* x = x1 + (rg * 4 + i) * kLD + cg16 + 16 * c;
          *x = __fmul_rn(acc[i][c], __fsub_rn(1.f, __fmul_rn(*x, *x)));
        }
    }
    __syncthreads();
    if (tile == tile0) SGA_STAMP(10);
    // gb1 and the gfold scatter: thread j walks the rows in order.
    for (int j = threadIdx.x; j < H1; j += blockDim.x) {
      float acc = ab1[j];
      for (int r = 0; r < rows; ++r) {
        const float gj = x1[r * kLD + j];
        acc = __fadd_rn(acc, gj);
        float* cell = gf + (size_t)s_idx[r] * H1 + j;
        *cell = __fadd_rn(*cell, gj);
      }
      ab1[j] = acc;
    }
    if (threadIdx.x == 0) {
      float acc = aloss[0];
      for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, rl[r]);
      aloss[0] = acc;
    }
    __syncthreads();
  }

  SGA_STAMP(11);
  // ---- the block's partial record -------------------------------------
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int j = (a < 4 ? 0 : 64) + rg * 4 + (a & 3);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int k = (b < 4 ? 0 : 64) + cg16 * 4 + (b & 3);
      if (j < H1 && k < H2) part[pl.w2 + j * H2 + k] = gw2[a][b];
    }
  }
  for (int c = threadIdx.x; c < H2 * A1; c += blockDim.x) {
    const int k = c / A1, a = c % A1;
    if (a < A) part[pl.wl + k * A + a] = aWh[k * kA1P + a];
    else part[pl.wv + k] = aWh[k * kA1P + a];
  }
  for (int a = threadIdx.x; a < A1; a += blockDim.x) {
    if (a < A) part[pl.bl + a] = abh[a];
    else part[pl.bv] = abh[a];
  }
  for (int k = threadIdx.x; k < H2; k += blockDim.x) part[pl.b2 + k] = ab2[k];
  for (int j = threadIdx.x; j < H1; j += blockDim.x) part[pl.b1 + j] = ab1[j];
  if (threadIdx.x == 0) part[pl.loss] = aloss[0];
  if (gf_smem) {
    for (int c = threadIdx.x; c < d.S * H1; c += blockDim.x) part[pl.gf + c] = gf[c];
  }
  SGA_STAMP(12);
}

struct Adam {
  float lr, max_norm, b1, omb1, b2, omb2, eps;
};

// Sums split over L lanes of a warp (L divides 32): for each output o <
// n_out, lane l adds its chunk part(o, l) in order, the L partials are
// added in a fixed butterfly (all lanes end with the same bits), and lane 0
// hands the sum to out(o, sum). Grid-stride, called by every thread.
template <int L, class Part, class Out>
__device__ __forceinline__ void split_sums(int n_out, Part part, Out out) {
  const int nth = gridDim.x * blockDim.x;
  const int total = (n_out * L + 31) / 32 * 32;  // whole warps per round
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += nth) {
    const int o = i / L, l = i % L;
    float acc = o < n_out ? part(o, l) : 0.f;
#pragma unroll
    for (int off = L / 2; off > 0; off /= 2)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (o < n_out && l == 0) out(o, acc);
  }
}

// Σ_{t in [t0, t1)} x(t)·y(t) in order, eight loads of each in flight.
template <class X, class Y>
__device__ __forceinline__ float dot_run(int t0, int t1, X x, Y y) {
  float acc = 0.f;
  int t = t0;
  for (; t + 8 <= t1; t += 8) {
    float a[8], b[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      a[q] = x(t + q);
      b[q] = y(t + q);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) acc = fmaf(a[q], b[q], acc);
  }
  for (; t < t1; ++t) acc = fmaf(x(t), y(t), acc);
  return acc;
}

// Sums the n_blocks partial records in block order, then gw1, the global
// norm, the clip and Adam, and the refold, with grid barriers between.
// red: [0] the update's loss sum, [1] the norm, [2] the running Σ of mean
// losses, [4 + b] block b's Σ g².
__global__ void __launch_bounds__(kThreads) finish_kernel(
    const float* __restrict__ obs, const float* __restrict__ partials, int n_blocks,
    Dims d, Offs o, float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
    float* __restrict__ fold, float* __restrict__ gfold, float* __restrict__ grad,
    float* __restrict__ red, int P, int u, int U, const int64_t* __restrict__ count0,
    int64_t* __restrict__ count_o, float* __restrict__ loss_o, Adam k) {
  cg::grid_group grid = cg::this_grid();
  const Part pl = part_layout(d);
  const int nth = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  __shared__ float sh[kThreads];
  float ss = 0.f;  // this thread's Σ g² over the elements it files

  SGA_STAMP(16);
  // 1. Sum the partial records (4 lanes an element, each over a quarter of
  // the blocks in block order) and file each element.
  const int cb = (n_blocks + 3) / 4;
  split_sums<4>(pl.G, [&](int e, int l) {
    float acc = 0.f;
    const int c1 = min(n_blocks, (l + 1) * cb);
    int c = l * cb;
    for (; c + 8 <= c1; c += 8) {
      float x[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) x[q] = partials[(size_t)(c + q) * pl.G + e];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc = __fadd_rn(acc, x[q]);
    }
    for (; c < c1; ++c) acc = __fadd_rn(acc, partials[(size_t)c * pl.G + e]);
    return acc;
  }, [&](int e, float acc) {
    if (e < pl.w2) {
      gfold[e] = acc;
      return;
    }
    if (e == pl.loss) {
      red[0] = acc;
      return;
    }
    int at;
    if (e < pl.b2) at = o.w2 + e - pl.w2;
    else if (e < pl.wl) at = o.b2 + e - pl.b2;
    else if (e < pl.wv) at = o.wl + e - pl.wl;
    else if (e < pl.bl) at = o.wv + e - pl.wv;
    else if (e < pl.bv) at = o.bl + e - pl.bl;
    else if (e < pl.b1) at = o.bv;
    else at = o.b1 + e - pl.b1;
    grad[at] = acc;
    ss = fmaf(acc, acc, ss);
  });
  grid.sync();
  SGA_STAMP(17);
  // 2. gw1[k, j] = Σ_s O[s, k]·gfold[s, j] (4 lanes an element, each over a
  // quarter of the states in order).
  const int cs = (d.S + 3) / 4;
  split_sums<4>(d.D * d.H1, [&](int i, int l) {
    const int kk = i / d.H1, j = i % d.H1;
    return dot_run(l * cs, min(d.S, (l + 1) * cs),
                   [&](int t) { return obs[(size_t)t * d.D + kk]; },
                   [&](int t) { return gfold[(size_t)t * d.H1 + j]; });
  }, [&](int i, float acc) {
    grad[o.w1 + i] = acc;
    ss = fmaf(acc, acc, ss);
  });
  sh[threadIdx.x] = ss;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] = __fadd_rn(sh[threadIdx.x], sh[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) red[4 + blockIdx.x] = sh[0];
  grid.sync();
  SGA_STAMP(18);
  // 3. The norm from the block partials (lane l adds blocks l, l+32, ... in
  // order, then a fixed butterfly); clip and Adam.
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int c = threadIdx.x; c < (int)gridDim.x; c += 32) s = __fadd_rn(s, red[4 + c]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (threadIdx.x == 0) sh[0] = __fsqrt_rn(s);
  }
  __syncthreads();
  const float gn = sh[0];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    red[1] = gn;
    const float loss_sum = u == 0 ? 0.f : red[2];
    red[2] = __fadd_rn(loss_sum, __fdiv_rn(red[0], (float)d.B));
    if (u == U - 1) {
      *loss_o = __fdiv_rn(red[2], (float)U);
      *count_o = *count0 + U;
    }
  }
  const float t = (float)(*count0 + u + 1);
  const float c1 = __fsub_rn(1.f, powf(k.b1, t));
  const float c2 = __fsub_rn(1.f, powf(k.b2, t));
  for (int i = tid; i < P; i += nth) {
    float g = grad[i];
    if (!(gn < k.max_norm)) g = __fmul_rn(__fdiv_rn(g, gn), k.max_norm);
    const float mm = __fadd_rn(__fmul_rn(k.omb1, g), __fmul_rn(k.b1, m[i]));
    const float vv = __fadd_rn(__fmul_rn(k.omb2, __fmul_rn(g, g)), __fmul_rn(k.b2, v[i]));
    m[i] = mm;
    v[i] = vv;
    const float upd =
        __fdiv_rn(__fdiv_rn(mm, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, c2)), k.eps));
    p[i] = __fadd_rn(p[i], __fmul_rn(-k.lr, upd));
  }
  grid.sync();
  SGA_STAMP(19);
  // 4. Refold with the new w1 for the next update (8 lanes an element, each
  // over an eighth of the observation in order).
  const float* w1 = p + o.w1;
  const int cd = (d.D + 7) / 8;
  split_sums<8>(d.S * d.H1, [&](int i, int l) {
    const int s = i / d.H1, j = i % d.H1;
    return dot_run(l * cd, min(d.D, (l + 1) * cd),
                   [&](int t) { return obs[(size_t)s * d.D + t]; },
                   [&](int t) { return w1[(size_t)t * d.H1 + j]; });
  }, [&](int i, float acc) { fold[i] = acc; });
  SGA_STAMP(20);
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

bool supported(const Dims& d) {
  return d.B >= 1 && d.A >= 2 && d.A + 1 <= kA1P && d.S >= 1 && d.D >= 1 && d.H1 >= 1 &&
         d.H2 >= 1 && d.H1 <= kHP && d.H2 <= kHP;
}

}  // namespace

#ifdef SGA_TRACE
// Copies the first n stamps ([update][phase], kStampN a row) to `host`.
extern "C" int ppo_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * sizeof(long long));
}
#endif

// The launch geometry for these shapes on a card of `n_sm` SMs: out =
// {tiles, tiles per block, grad blocks, gfold in shared memory, grad
// shared-memory bytes, scratch floats}; all 0 if the shapes are not taken.
// Mirrored by ops/ppo_kernel.py::geometry.
extern "C" void ppo_optimize_geometry(int S, int D, int H1, int H2, int A, int P, int B,
                                      int n_sm, long long* out) {
  const Dims d = make_dims(S, D, H1, H2, A, B);
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (!supported(d) || n_sm < 1) return;
  const Geo g = make_geo(d, n_sm);
  if (g.smem > kMaxSmem) return;
  out[0] = g.tiles;
  out[1] = g.tpb;
  out[2] = g.grid;
  out[3] = g.gf_smem;
  out[4] = (long long)g.smem;
  out[5] = 2LL * S * H1 + P + 4 + kMaxFinish + (long long)g.grid * part_layout(d).G;
}

// Launch on `stream`; returns a CUDA error code (0 on success). `state`
// holds the flat params, μ and ν back to back (P floats each) and is
// updated in place; `offs` (host memory) gives the offsets of w1, b1, W2,
// b2, Wl, bl, Wv, bv in the flat layout. Streams are [U, B]: state index,
// action, old logp, advantage, return. `ce` is a device f32 scalar (the
// entropy coefficient), `count0` a device int64 (Adam steps so far).
// `scratch` holds ppo_optimize_geometry's scratch floats for `n_sm`.
extern "C" int ppo_optimize_launch(
    const void* obs, int S, int D, int H1, int H2, int A, const int* offs,
    int P, void* state, const void* count0, const void* ce,
    const void* sidx, const void* act, const void* olp, const void* adv,
    const void* ret, int U, int B, float lr, float clip_lo, float clip_hi,
    float value_coef, float max_norm, float beta1, float omb1, float beta2,
    float omb2, float eps, int n_sm, void* scratch, void* count_o, void* loss_o,
    void* stream) {
  const Dims d = make_dims(S, D, H1, H2, A, B);
  if (U < 1 || n_sm < 1 || !supported(d)) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(d, n_sm);
  if (g.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, finish_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // Up to four co-resident blocks per SM (the cooperative limit is per_sm).
  int n_fin = sms * (per_sm < 4 ? per_sm : 4);
  if (n_fin > kMaxFinish) n_fin = kMaxFinish;
  e = cudaFuncSetAttribute(grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)g.smem);
  if (e != cudaSuccess) return (int)e;
  Offs o;
  o.w1 = offs[0];
  o.b1 = offs[1];
  o.w2 = offs[2];
  o.b2 = offs[3];
  o.wl = offs[4];
  o.bl = offs[5];
  o.wv = offs[6];
  o.bv = offs[7];
  cudaStream_t st = (cudaStream_t)stream;
  float* p = (float*)state;
  float* m = p + P;
  float* v = m + P;
  float* fold = (float*)scratch;
  float* gfold = fold + (size_t)S * H1;
  float* grad = gfold + (size_t)S * H1;
  float* red = grad + P;
  float* partials = red + 4 + kMaxFinish;
  Adam k;
  k.lr = lr;
  k.max_norm = max_norm;
  k.b1 = beta1;
  k.omb1 = omb1;
  k.b2 = beta2;
  k.omb2 = omb2;
  k.eps = eps;
  const float* O = (const float*)obs;
  const int64_t* c0 = (const int64_t*)count0;
  int64_t* cnt_o = (int64_t*)count_o;
  float* lss_o = (float*)loss_o;
  fold_kernel<<<(S * H1 + kThreads - 1) / kThreads, kThreads, 0, st>>>(O, p, o, d, fold);
  int n_blocks = g.grid;
  for (int u = 0; u < U; ++u) {
    grad_kernel<<<g.grid, kThreads, g.smem, st>>>(
        p, o, d, g.tpb, g.gf_smem, fold, (const int32_t*)sidx, (const int32_t*)act,
        (const float*)olp, (const float*)adv, (const float*)ret, u, (const float*)ce,
        clip_lo, clip_hi, value_coef, partials);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&O, (void*)&partials, (void*)&n_blocks, (void*)&d, (void*)&o,
                    (void*)&p, (void*)&m, (void*)&v, (void*)&fold, (void*)&gfold,
                    (void*)&grad, (void*)&red, (void*)&P, (void*)&u, (void*)&U,
                    (void*)&c0, (void*)&cnt_o, (void*)&lss_o, (void*)&k};
    e = cudaLaunchCooperativeKernel((const void*)finish_kernel, dim3(n_fin), dim3(kThreads),
                                    args, 0, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
