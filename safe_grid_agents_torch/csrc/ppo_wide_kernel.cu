// PPO optimize, wide route: every epoch × minibatch update of the
// table-folded actor-critic — forward, clipped surrogate + value + entropy
// loss, its hand-derived backward, global-norm clip, Adam and the refold —
// for U updates in one C entry point on one stream.
//
// Replaces safe_grid_agents_tpu/ops/ppo_kernel.py::_kernel (launched by
// ppo_optimize_run through pl.pallas_call) for the shapes that the
// persistent design (ppo_kernel.cu) does not take: it pads the hidden
// layers to 128 and the heads to 8 in shared memory, so hidden widths above
// 128 or more than 7 actions come here; ops/ppo_kernel.py::route picks this
// kernel from the shape alone, before the launch. Here the row tile shrinks
// with the width instead (64 rows up to width 128, 32 at 256, ...;
// make_dims). The TPU kernel streams each minibatch through ONE core in
// 1024-lane sub-blocks (its sequential grid carries the gradient sums in
// VMEM) and reads the batch's states through a one-hot matmul against the
// fold foldT = w1ᵀ·Oᵀ. On the card the B rows
// of a minibatch are the parallel dimension, and each update is six short
// kernels, in order on the stream:
//
//   1. fold     fold[S, H1] = O·w1 (before the first update, then after
//               each update's Adam);
//   2. grad     one block per row tile: gathers fold[idx] for layer 1, runs
//               the forward, the per-row loss and its gradient dL/d(logits,
//               value), and the backward, and writes the block's partial
//               gradient sums (gfold [S, H1], W2, b2, heads, b1, loss) to
//               its own slot of a device scratch;
//   3. reduce   sums the partials over the blocks in block order;
//   4. gw1      gw1 = Oᵀ·gfold, summed over states in order;
//   5. norm     one block: the global norm over all parameters and the
//               running loss;
//   6. adam     clip (optax: g if |g| < max_norm else g/|g|·max_norm), then
//               Adam with bias correction 1 − β^(count0 + u + 1).
//
// Every sum runs in a fixed order and no float atomics are used, so the
// kernel is reproducible run to run. The parameters, Adam's moments and
// the gradient are flat vectors in the agent's ravel order (sorted names);
// the caller passes the offsets of w1, b1, Dense_0 (W2, b2), Dense_1 (the
// logits head Wl, bl) and Dense_2 (the value head Wv, bv).
//
// What bounds it on this card: the island preset at hidden 256 (16 updates
// of 16,384 rows, D = 288) does ~52 G multiply-adds, float32 operations,
// ~1.6 ms at 67 TFLOP/s. This design runs on the CUDA cores with the
// activations of a row tile in shared memory and the weights read through
// L1/L2; the partial sums cost tens of MB of L2 traffic per update and each
// update pays six launches. It was the first design of B6 (PRs 3-5) and is
// kept as the route for wide nets.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRB = 8;               // rows per thread item in the products
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

struct Dims {
  int S, D, H1, H2, A, B, R;
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

// Shared memory of the grad kernel without the gfold buffer (floats).
__host__ __device__ size_t grad_smem_floats(const Dims& d) {
  return (size_t)d.R * (5 + 2 * d.H1 + 2 * d.H2 + (d.A + 1) + 1);
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

__global__ void __launch_bounds__(kThreads) grad_kernel(
    const float* __restrict__ p, Offs o, Dims d,
    const float* __restrict__ fold, const int32_t* __restrict__ sidx,
    const int32_t* __restrict__ act, const float* __restrict__ olp,
    const float* __restrict__ adv, const float* __restrict__ ret, int u,
    const float* __restrict__ ce_p, float clip_lo, float clip_hi,
    float value_coef, int gf_in_smem, float* __restrict__ partials) {
  const int R = d.R, H1 = d.H1, H2 = d.H2, A = d.A, A1 = d.A + 1;
  const Part pl = part_layout(d);
  extern __shared__ __align__(16) float smem[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem);
  int32_t* s_act = s_idx + R;
  float* s_olp = reinterpret_cast<float*>(s_act + R);
  float* s_adv = s_olp + R;
  float* s_ret = s_adv + R;
  float* x1 = s_ret + R;     // [R, H1]
  float* x2 = x1 + R * H1;   // [R, H2]
  float* g2 = x2 + R * H2;   // [R, H2] dL/d(pre-activation 2)
  float* g1 = g2 + R * H2;   // [R, H1] dL/d(pre-activation 1)
  float* dl = g1 + R * H1;   // [R, A+1] dL/d(logits, value); head output first
  float* rl = dl + R * A1;   // [R] row losses
  float* part = partials + (size_t)blockIdx.x * pl.G;
  float* gf = gf_in_smem ? rl + R : part + pl.gf;  // [S, H1] gfold partial

  const float* W2 = p + o.w2;
  const float* b2 = p + o.b2;
  const float* Wl = p + o.wl;
  const float* bl = p + o.bl;
  const float* Wv = p + o.wv;
  const float* bv = p + o.bv;
  const float* b1 = p + o.b1;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, d.B - row0);

  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const size_t at = (size_t)u * d.B + row0 + r;
    const bool live = r < rows;
    s_idx[r] = live ? sidx[at] : 0;
    s_act[r] = live ? act[at] : 0;
    s_olp[r] = live ? olp[at] : 0.f;
    s_adv[r] = live ? adv[at] : 0.f;
    s_ret[r] = live ? ret[at] : 0.f;
  }
  for (int c = threadIdx.x; c < d.S * H1; c += blockDim.x) gf[c] = 0.f;
  __syncthreads();

  // ---- forward --------------------------------------------------------
  // Layer 1 from the fold: x1 = tanh(fold[idx] + b1).
  for (int c = threadIdx.x; c < R * H1; c += blockDim.x) {
    const int r = c / H1, j = c % H1;
    x1[c] = tanhf(__fadd_rn(fold[(size_t)s_idx[r] * H1 + j], b1[j]));
  }
  __syncthreads();
  // Layer 2: x2 = tanh(x1·W2 + b2); item = (8 rows, one column).
  for (int item = threadIdx.x; item < (R / kRB) * H2; item += blockDim.x) {
    const int n = item % H2, r0 = (item / H2) * kRB;
    float acc[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i) acc[i] = 0.f;
    for (int k = 0; k < H1; ++k) {
      const float w = W2[(size_t)k * H2 + n];
#pragma unroll
      for (int i = 0; i < kRB; ++i) acc[i] = fmaf(x1[(r0 + i) * H1 + k], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i) x2[(r0 + i) * H2 + n] = tanhf(__fadd_rn(acc[i], b2[n]));
  }
  __syncthreads();
  // Heads: y[r, a] = x2·Wl + bl (a < A), y[r, A] = x2·Wv + bv.
  for (int c = threadIdx.x; c < R * A1; c += blockDim.x) {
    const int r = c / A1, a = c % A1;
    float acc = 0.f;
    if (a < A) {
      for (int k = 0; k < H2; ++k) acc = fmaf(x2[r * H2 + k], Wl[k * A + a], acc);
      dl[c] = __fadd_rn(acc, bl[a]);
    } else {
      for (int k = 0; k < H2; ++k) acc = fmaf(x2[r * H2 + k], Wv[k], acc);
      dl[c] = __fadd_rn(acc, bv[0]);
    }
  }
  __syncthreads();

  // ---- per row: loss and dL/d(logits, value) (ppo_kernel.py:127-175) -----
  const float ce = *ce_p;
  const float inv_b = __fdiv_rn(1.f, (float)d.B);
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float* y = dl + r * A1;
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

  // ---- backward ---------------------------------------------------------
  // g2 = (dl·Whᵀ) ⊙ (1 − x2²)
  for (int c = threadIdx.x; c < R * H2; c += blockDim.x) {
    const int r = c / H2, k = c % H2;
    const float* y = dl + r * A1;
    float acc = 0.f;
    for (int a = 0; a < A; ++a) acc = fmaf(y[a], Wl[k * A + a], acc);
    acc = fmaf(y[A], Wv[k], acc);
    const float x = x2[c];
    g2[c] = __fmul_rn(acc, __fsub_rn(1.f, __fmul_rn(x, x)));
  }
  __syncthreads();
  // g1 = (g2·W2ᵀ) ⊙ (1 − x1²); item = (8 rows, one hidden unit j).
  for (int item = threadIdx.x; item < (R / kRB) * H1; item += blockDim.x) {
    const int j = item % H1, r0 = (item / H1) * kRB;
    float acc[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i) acc[i] = 0.f;
    for (int k = 0; k < H2; ++k) {
      const float w = W2[(size_t)j * H2 + k];
#pragma unroll
      for (int i = 0; i < kRB; ++i) acc[i] = fmaf(g2[(r0 + i) * H2 + k], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const float x = x1[(r0 + i) * H1 + j];
      g1[(r0 + i) * H1 + j] = __fmul_rn(acc[i], __fsub_rn(1.f, __fmul_rn(x, x)));
    }
  }
  __syncthreads();

  // ---- this block's partial sums, each element over rows in order --------
  // gW2[j, k] = Σ_r x1[r, j]·g2[r, k]; item = (8 hidden units j, one k).
  for (int item = threadIdx.x; item < ((H1 + kRB - 1) / kRB) * H2; item += blockDim.x) {
    const int k = item % H2, j0 = (item / H2) * kRB;
    float acc[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i) acc[i] = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float g = g2[r * H2 + k];
#pragma unroll
      for (int i = 0; i < kRB; ++i)
        if (j0 + i < H1) acc[i] = fmaf(x1[r * H1 + j0 + i], g, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i)
      if (j0 + i < H1) part[pl.w2 + (j0 + i) * H2 + k] = acc[i];
  }
  // Heads: gWl[k, a], gWv[k] = Σ_r x2[r, k]·dl[r, a]; biases Σ_r dl[r, a].
  for (int c = threadIdx.x; c < H2 * A1 + A1; c += blockDim.x) {
    float acc = 0.f;
    if (c < H2 * A1) {
      const int k = c / A1, a = c % A1;
      for (int r = 0; r < rows; ++r) acc = fmaf(x2[r * H2 + k], dl[r * A1 + a], acc);
      if (a < A) part[pl.wl + k * A + a] = acc;
      else part[pl.wv + k] = acc;
    } else {
      const int a = c - H2 * A1;
      for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, dl[r * A1 + a]);
      if (a < A) part[pl.bl + a] = acc;
      else part[pl.bv] = acc;
    }
  }
  for (int k = threadIdx.x; k < H2; k += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, g2[r * H2 + k]);
    part[pl.b2 + k] = acc;
  }
  // gb1 and the gfold scatter: thread j walks the rows in order.
  for (int j = threadIdx.x; j < H1; j += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float g = g1[r * H1 + j];
      acc = __fadd_rn(acc, g);
      float* cell = gf + (size_t)s_idx[r] * H1 + j;
      *cell = __fadd_rn(*cell, g);
    }
    part[pl.b1 + j] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, rl[r]);
    part[pl.loss] = acc;
  }
  if (gf_in_smem) {
    __syncthreads();
    for (int c = threadIdx.x; c < d.S * H1; c += blockDim.x) part[pl.gf + c] = gf[c];
  }
}

// Sums element e of every block's partial record in block order and files
// it: gfold, the flat gradient, or the update's loss sum (red[0]).
__global__ void reduce_kernel(const float* __restrict__ partials, int n_blocks,
                              Dims d, Offs o, float* __restrict__ gfold,
                              float* __restrict__ grad, float* __restrict__ red) {
  const Part pl = part_layout(d);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pl.G) return;
  float acc = 0.f;
  for (int c = 0; c < n_blocks; ++c) acc = __fadd_rn(acc, partials[(size_t)c * pl.G + e]);
  if (e < pl.w2) gfold[e] = acc;
  else if (e < pl.b2) grad[o.w2 + e - pl.w2] = acc;
  else if (e < pl.wl) grad[o.b2 + e - pl.b2] = acc;
  else if (e < pl.wv) grad[o.wl + e - pl.wl] = acc;
  else if (e < pl.bl) grad[o.wv + e - pl.wv] = acc;
  else if (e < pl.bv) grad[o.bl + e - pl.bl] = acc;
  else if (e < pl.b1) grad[o.bv] = acc;
  else if (e < pl.loss) grad[o.b1 + e - pl.b1] = acc;
  else red[0] = acc;
}

// gw1[k, j] = Σ_s O[s, k]·gfold[s, j], summed over s in order.
__global__ void gw1_kernel(const float* __restrict__ obs,
                           const float* __restrict__ gfold, Dims d, Offs o,
                           float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d.D * d.H1) return;
  const int k = i / d.H1, j = i % d.H1;
  float acc = 0.f;
  for (int s = 0; s < d.S; ++s)
    acc = fmaf(obs[(size_t)s * d.D + k], gfold[(size_t)s * d.H1 + j], acc);
  grad[o.w1 + i] = acc;
}

// One block: red[1] = global norm of the flat gradient; red[2] += this
// update's mean loss; after the last update, the loss mean and the count.
__global__ void __launch_bounds__(1024) norm_kernel(
    const float* __restrict__ grad, int P, float* __restrict__ red, int B,
    int u, int U, const int64_t* __restrict__ count0,
    int64_t* __restrict__ count_o, float* __restrict__ loss_o) {
  __shared__ float part[1024];
  float acc = 0.f;
  for (int i = threadIdx.x; i < P; i += blockDim.x) acc = fmaf(grad[i], grad[i], acc);
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    red[1] = __fsqrt_rn(part[0]);
    const float loss_sum = u == 0 ? 0.f : red[2];
    red[2] = __fadd_rn(loss_sum, __fdiv_rn(red[0], (float)B));
    if (u == U - 1) {
      *loss_o = __fdiv_rn(red[2], (float)U);
      *count_o = *count0 + U;
    }
  }
}

struct Adam {
  float lr, max_norm, b1, omb1, b2, omb2, eps;
};

// Clip by the global norm red[1], then one Adam step of every element.
__global__ void adam_kernel(float* __restrict__ p, float* __restrict__ m,
                            float* __restrict__ v, const float* __restrict__ grad,
                            int P, const float* __restrict__ red,
                            const int64_t* __restrict__ count0, int u, Adam k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const float gn = red[1];
  float g = grad[i];
  if (!(gn < k.max_norm)) g = __fmul_rn(__fdiv_rn(g, gn), k.max_norm);
  const float t = (float)(*count0 + u + 1);
  const float c1 = __fsub_rn(1.f, powf(k.b1, t));
  const float c2 = __fsub_rn(1.f, powf(k.b2, t));
  const float mm = __fadd_rn(__fmul_rn(k.omb1, g), __fmul_rn(k.b1, m[i]));
  const float vv = __fadd_rn(__fmul_rn(k.omb2, __fmul_rn(g, g)), __fmul_rn(k.b2, v[i]));
  m[i] = mm;
  v[i] = vv;
  const float upd = __fdiv_rn(__fdiv_rn(mm, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, c2)), k.eps));
  p[i] = __fadd_rn(p[i], __fmul_rn(-k.lr, upd));
}

Dims make_dims(int S, int D, int H1, int H2, int A, int B) {
  Dims d;
  d.S = S;
  d.D = D;
  d.H1 = H1;
  d.H2 = H2;
  d.A = A;
  d.B = B;
  // 64 rows per block at hidden widths up to 128; fewer for wider nets.
  const int h = H1 > H2 ? H1 : H2;
  int R = 64;
  while (R > kRB && (size_t)R * h > 64 * 128) R /= 2;
  d.R = R;
  return d;
}

int n_blocks(const Dims& d) { return (d.B + d.R - 1) / d.R; }

}  // namespace

// The launch's layout for these shapes: out = {rows per grad block, grad
// blocks, gfold partial in shared memory (1) or in the record (0), the grad
// kernel's shared-memory bytes (0: too large, not taken), floats of device
// scratch: fold and gfold [S, H1], the flat gradient [P], 4 scalars and one
// partial record per grad block}. Mirrored by
// ops/ppo_kernel.py::wide_geometry.
extern "C" void ppo_wide_geometry(int S, int D, int H1, int H2, int A, int P, int B,
                                  long long* out) {
  const Dims d = make_dims(S, D, H1, H2, A, B);
  size_t smem = grad_smem_floats(d) * 4;
  const size_t gf_bytes = (size_t)S * H1 * 4;
  const int gf_in_smem = smem + gf_bytes <= kMaxSmem ? 1 : 0;
  if (gf_in_smem) smem += gf_bytes;
  out[0] = d.R;
  out[1] = n_blocks(d);
  out[2] = gf_in_smem;
  out[3] = smem > kMaxSmem ? 0 : (long long)smem;
  out[4] = 2LL * S * H1 + P + 4 + (long long)n_blocks(d) * part_layout(d).G;
}

// Launch on `stream`; returns a CUDA error code (0 on success). `scratch`
// holds the floats ppo_wide_geometry gives. `state`
// holds the flat params, μ and ν back to back (P floats each) and is
// updated in place; `offs` (host memory) gives the offsets of w1, b1, W2,
// b2, Wl, bl, Wv, bv in the flat layout. Streams are [U, B]: state index,
// action, old logp, advantage, return. `ce` is a device f32 scalar (the
// entropy coefficient), `count0` a device int64 (Adam steps so far).
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
  const Dims d = make_dims(S, D, H1, H2, A, B);
  const Part pl = part_layout(d);
  const int nb = n_blocks(d);
  Offs o;
  o.w1 = offs[0];
  o.b1 = offs[1];
  o.w2 = offs[2];
  o.b2 = offs[3];
  o.wl = offs[4];
  o.bl = offs[5];
  o.wv = offs[6];
  o.bv = offs[7];
  size_t smem = grad_smem_floats(d) * 4;
  const size_t gf_bytes = (size_t)S * H1 * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int gf_in_smem = smem + gf_bytes <= kMaxSmem ? 1 : 0;
  if (gf_in_smem) smem += gf_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  float* p = (float*)state;
  float* m = p + P;
  float* v = m + P;
  float* fold = (float*)scratch;
  float* gfold = fold + (size_t)S * H1;
  float* grad = gfold + (size_t)S * H1;
  float* red = grad + P;
  float* partials = red + 4;
  Adam k;
  k.lr = lr;
  k.max_norm = max_norm;
  k.b1 = beta1;
  k.omb1 = omb1;
  k.b2 = beta2;
  k.omb2 = omb2;
  k.eps = eps;
  const int T = kThreads;
  const float* O = (const float*)obs;
  const int64_t* c0 = (const int64_t*)count0;
  fold_kernel<<<(S * H1 + T - 1) / T, T, 0, st>>>(O, p, o, d, fold);
  for (int u = 0; u < U; ++u) {
    grad_kernel<<<nb, T, smem, st>>>(
        p, o, d, fold, (const int32_t*)sidx, (const int32_t*)act,
        (const float*)olp, (const float*)adv, (const float*)ret, u,
        (const float*)ce, clip_lo, clip_hi, value_coef, gf_in_smem, partials);
    reduce_kernel<<<(pl.G + T - 1) / T, T, 0, st>>>(partials, nb, d, o, gfold,
                                                     grad, red);
    gw1_kernel<<<(D * H1 + T - 1) / T, T, 0, st>>>(O, gfold, d, o, grad);
    norm_kernel<<<1, 1024, 0, st>>>(grad, P, red, B, u, U, c0,
                                    (int64_t*)count_o, (float*)loss_o);
    adam_kernel<<<(P + T - 1) / T, T, 0, st>>>(p, m, v, grad, P, red, c0, u, k);
    fold_kernel<<<(S * H1 + T - 1) / T, T, 0, st>>>(O, p, o, d, fold);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
