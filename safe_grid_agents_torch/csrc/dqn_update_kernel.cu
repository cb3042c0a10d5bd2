// DQN update: U sampled TD updates of a two-hidden-layer ReLU Q-net in one
// thread block — forward, Huber loss, hand-derived backward, Adam and the
// scheduled target sync, update after update.
//
// Replaces safe_grid_agents_tpu/ops/dqn_update_kernel.py::_kernel (launched
// by dqn_update_run through pl.pallas_call). The TPU kernel reads the
// batch's observations through one-hot matmuls against a fold
// foldT = w1ᵀ·Oᵀ over ALL states, recomputed after every update, because
// Mosaic rejects row gathers; here each update gathers its B observation
// rows O[idx] straight from the [S, D] table (about 4.7 MFLOP per update
// against 48 MFLOP for the fold at sokoban's size).
//
// What bounds it on this card: update u+1 reads the parameters update u
// wrote, so the U updates are a serial chain, and this first design runs
// the chain in ONE block of 1024 threads (1 of 132 SMs). Per update it
// does ~16 M float multiply-adds (the forward passes of the online and
// target nets, the backward, Adam over 35,588 parameters at sokoban's
// width) with a block barrier between every layer: it is bound by one SM's
// float rate and barrier latency, far above the card-wide bound. The four
// parameter sets (params, target, Adam μ and ν, ~142 KB each at width 128)
// stay in device memory, where they remain L2-resident; the batch's
// activations x1, x2 and one backward buffer ([B, 128] f32 each, 64 KB at
// B = 128) sit in shared memory when they fit and in an L2-resident
// device scratch otherwise. Spreading an update over many SMs is later work.
//
// Numerics: each gradient element is the sum over the batch by ONE thread
// in a fixed order (no float atomics), so the kernel is reproducible run to
// run. Every gradient element is consumed by Adam in the thread that summed
// it (optax.adam: μ = (1−β1)g + β1μ, ν = (1−β2)g² + β2ν, bias corrections
// 1 − βᵗ, p += −lr·μ̂/(√ν̂ + ε), no clip), in round-to-nearest intrinsics. The
// backward reads each weight before Adam overwrites it. The plain PyTorch
// version differs only in summation order (matmuls, autograd).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRB = 8;               // rows (or reduction outputs) per thread item
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

struct Adam {
  float b1, omb1, b2, omb2, c1, c2, eps, neglr;
};

__device__ __forceinline__ void adam_step(float* p, float* m, float* v, int i,
                                          float g, const Adam& k) {
  const float mm = __fadd_rn(__fmul_rn(k.omb1, g), __fmul_rn(k.b1, m[i]));
  const float vv =
      __fadd_rn(__fmul_rn(k.omb2, __fmul_rn(g, g)), __fmul_rn(k.b2, v[i]));
  m[i] = mm;
  v[i] = vv;
  const float mh = __fdiv_rn(mm, k.c1);
  const float vh = __fdiv_rn(vv, k.c2);
  const float upd = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), k.eps));
  p[i] = __fadd_rn(p[i], __fmul_rn(k.neglr, upd));
}

// out[b·N + n] = epilogue(Σ_k in(b, k) · W(k, n)) for b < B, n < N, where
// in(b, k) = in[row(b)·ld + k] with row(b) = rows ? rows[b] : b, and
// W(k, n) = W[k·N + n] (or W[n·K + k] if transposed). Epilogues: 0 adds
// bias[n]; 1 adds bias[n] then ReLU; 2 keeps the sum where mask[b·N+n] > 0
// and writes 0 elsewhere (the ReLU derivative).
__device__ void dense(const float* in, const int32_t* rows, int ld, int K,
                      const float* W, bool transposed, int N, int B,
                      int epilogue, const float* bias, const float* mask,
                      float* out) {
  const int ntile = (B + kRB - 1) / kRB;
  for (int item = threadIdx.x; item < ntile * N; item += blockDim.x) {
    const int n = item % N;
    const int b0 = (item / N) * kRB;
    float acc[kRB];
    int base[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      acc[i] = 0.f;
      const int b = min(b0 + i, B - 1);
      base[i] = (rows ? rows[b] : b) * ld;
    }
    for (int k = 0; k < K; ++k) {
      const float w = transposed ? W[(size_t)n * K + k] : W[(size_t)k * N + n];
#pragma unroll
      for (int i = 0; i < kRB; ++i) acc[i] = fmaf(in[base[i] + k], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const int b = b0 + i;
      if (b >= B) break;
      float y = acc[i];
      if (epilogue == 2) {
        y = mask[b * N + n] > 0.f ? y : 0.f;
      } else {
        y = __fadd_rn(y, bias[n]);
        if (epilogue == 1) y = fmaxf(y, 0.f);
      }
      out[b * N + n] = y;
    }
  }
}

// Weight gradient G(r, n) = Σ_b X(b, r) · Y[b·N + n] (X(b, r) = X[row(b)·ldx
// + r]) for r < R, n < N, each element summed over b in order by one thread
// and handed straight to Adam for parameter element r·N + n.
__device__ void weight_grad_adam(const float* X, const int32_t* rows, int ldx,
                                 int R, const float* Y, int N, int B,
                                 float* p, float* m, float* v, const Adam& k) {
  const int ntile = (R + kRB - 1) / kRB;
  for (int item = threadIdx.x; item < ntile * N; item += blockDim.x) {
    const int n = item % N;
    const int r0 = (item / N) * kRB;
    float acc[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i) acc[i] = 0.f;
    for (int b = 0; b < B; ++b) {
      const float y = Y[b * N + n];
      const float* xr = X + (rows ? rows[b] : b) * ldx + r0;
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        if (r0 + i < R) acc[i] = fmaf(xr[i], y, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      if (r0 + i < R) adam_step(p, m, v, (r0 + i) * N + n, acc[i], k);
    }
  }
}

// Bias gradient g(n) = Σ_b Y[b·N + n], in order, then Adam.
__device__ void bias_grad_adam(const float* Y, int N, int B, float* p, float* m,
                               float* v, const Adam& k) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float g = 0.f;
    for (int b = 0; b < B; ++b) g = __fadd_rn(g, Y[b * N + n]);
    adam_step(p, m, v, n, g, k);
  }
}

struct Net {
  float *w1, *b1, *w2, *b2, *w3, *b3;
};

__device__ Net net_at(float* base, int D, int H1, int H2, int A) {
  Net n;
  n.w1 = base;
  n.b1 = n.w1 + D * H1;
  n.w2 = n.b1 + H1;
  n.b2 = n.w2 + H1 * H2;
  n.w3 = n.b2 + H2;
  n.b3 = n.w3 + H2 * A;
  return n;
}

// Q[b·A + a] of net `net` on observation rows O[rows[b]]; x1, x2 keep the
// hidden activations.
__device__ void forward(const Net& net, const float* obs, const int32_t* rows,
                        int D, int H1, int H2, int A, int B, float* x1,
                        float* x2, float* q) {
  dense(obs, rows, D, D, net.w1, false, H1, B, 1, net.b1, nullptr, x1);
  __syncthreads();
  dense(x1, nullptr, H1, H1, net.w2, false, H2, B, 1, net.b2, nullptr, x2);
  __syncthreads();
  dense(x2, nullptr, H2, H2, net.w3, false, A, B, 0, net.b3, nullptr, q);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) dqn_update_kernel(
    const float* __restrict__ obs, int D, int H1, int H2, int A,
    float* __restrict__ state, int P, const int64_t* __restrict__ count0,
    const int64_t* __restrict__ upd0, const int32_t* __restrict__ s_idx,
    const int32_t* __restrict__ n_idx, const int32_t* __restrict__ act,
    const float* __restrict__ rew, const uint8_t* __restrict__ done, int U,
    int B, float lr, float gamma_n, float beta1, float omb1, float beta2,
    float omb2, float eps, int sync_every, int double_q,
    float* __restrict__ scratch,
    int64_t* __restrict__ count_o, int64_t* __restrict__ upd_o,
    float* __restrict__ loss_o) {
  const int Hm = H1 > H2 ? H1 : H2;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sh_s = reinterpret_cast<int32_t*>(smem);
  int32_t* sh_n = sh_s + B;
  int32_t* sh_a = sh_n + B;
  float* sh_r = reinterpret_cast<float*>(sh_a + B);
  int32_t* sh_d = reinterpret_cast<int32_t*>(sh_r + B);
  float* q = reinterpret_cast<float*>(sh_d + B);  // [B, A] online Q on s
  float* tq = q + B * A;                          // [B, A] target Q on s'
  float* qn = tq + B * A;                         // [B, A] online Q on s'
  float* dqs = qn + B * A;                        // [B] ∂loss/∂q_sa
  float* hub = dqs + B;                           // [B] Huber losses
  float* big = scratch ? scratch : hub + B;
  float* x1 = big;                                // [B, H1]
  float* x2 = x1 + B * Hm;                        // [B, H2], then ∂x1 masked
  float* g2 = x2 + B * Hm;                        // [B, H2] ∂x2 masked

  const Net on = net_at(state, D, H1, H2, A);
  const Net tg = net_at(state + P, D, H1, H2, A);
  const Net mu = net_at(state + 2 * P, D, H1, H2, A);
  const Net nu = net_at(state + 3 * P, D, H1, H2, A);
  const int64_t c0 = *count0, n0 = *upd0;
  const float inv_b = __fdiv_rn(1.f, (float)B);
  float loss_acc = 0.f;  // thread 0's running Σ of per-update mean losses

  for (int u = 0; u < U; ++u) {
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      const size_t o = (size_t)u * B + b;
      sh_s[b] = s_idx[o];
      sh_n[b] = n_idx[o];
      sh_a[b] = act[o];
      sh_r[b] = rew[o];
      sh_d[b] = done[o];
    }
    __syncthreads();

    // ---- forward: target on s', online on s' (double-Q), online on s ----
    forward(tg, obs, sh_n, D, H1, H2, A, B, x1, x2, tq);
    if (double_q) forward(on, obs, sh_n, D, H1, H2, A, B, x1, x2, qn);
    forward(on, obs, sh_s, D, H1, H2, A, B, x1, x2, q);

    // ---- per sample: bootstrap, target, Huber and its derivative --------
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      const float* tr = tq + b * A;
      float boot;
      if (double_q) {  // the online net picks a* (first max), target values it
        const float* qr = qn + b * A;
        int astar = 0;
        float m = qr[0];
        for (int a = 1; a < A; ++a) {
          if (qr[a] > m) { m = qr[a]; astar = a; }
        }
        boot = tr[astar];
      } else {
        boot = tr[0];
        for (int a = 1; a < A; ++a) boot = fmaxf(boot, tr[a]);
      }
      const float target =
          __fadd_rn(sh_r[b], __fmul_rn(gamma_n, sh_d[b] ? 0.f : boot));
      const float diff = __fsub_rn(q[b * A + sh_a[b]], target);
      const float ad = fabsf(diff);
      const float quad = fminf(ad, 1.f);
      hub[b] = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, quad), quad),
                         __fsub_rn(ad, quad));
      dqs[b] = __fmul_rn(fminf(fmaxf(diff, -1.f), 1.f), inv_b);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int b = 0; b < B; ++b) s = __fadd_rn(s, hub[b]);
      loss_acc = __fadd_rn(loss_acc, __fmul_rn(s, inv_b));
    }

    Adam k;
    const float t = (float)(c0 + u + 1);
    k.b1 = beta1;
    k.omb1 = omb1;
    k.b2 = beta2;
    k.omb2 = omb2;
    k.c1 = __fsub_rn(1.f, powf(beta1, t));
    k.c2 = __fsub_rn(1.f, powf(beta2, t));
    k.eps = eps;
    k.neglr = -lr;

    // ---- backward through the head: ∂x2 (masked) with the OLD w3 -------
    for (int i = threadIdx.x; i < B * H2; i += blockDim.x) {
      const int b = i / H2, h = i % H2;
      g2[i] = x2[i] > 0.f ? __fmul_rn(dqs[b], on.w3[h * A + sh_a[b]]) : 0.f;
    }
    __syncthreads();
    // Head gradients (x2 and dqs) -> Adam on w3, b3; bias of layer 2.
    for (int i = threadIdx.x; i < H2 * A + A; i += blockDim.x) {
      float g = 0.f;
      if (i < H2 * A) {
        const int h = i / A, a = i % A;
        for (int b = 0; b < B; ++b) {
          if (sh_a[b] == a) g = fmaf(x2[b * H2 + h], dqs[b], g);
        }
        adam_step(on.w3, mu.w3, nu.w3, i, g, k);
      } else {
        const int a = i - H2 * A;
        for (int b = 0; b < B; ++b) {
          if (sh_a[b] == a) g = __fadd_rn(g, dqs[b]);
        }
        adam_step(on.b3, mu.b3, nu.b3, a, g, k);
      }
    }
    bias_grad_adam(g2, H2, B, on.b2, mu.b2, nu.b2, k);
    __syncthreads();
    // ∂x1 (masked by x1 > 0) with the OLD w2, into x2's buffer.
    float* g1 = x2;
    dense(g2, nullptr, H2, H2, on.w2, true, H1, B, 2, nullptr, x1, g1);
    __syncthreads();
    // Layer-2 and layer-1 gradients -> Adam on w2, b1, w1.
    weight_grad_adam(x1, nullptr, H1, H1, g2, H2, B, on.w2, mu.w2, nu.w2, k);
    bias_grad_adam(g1, H1, B, on.b1, mu.b1, nu.b1, k);
    weight_grad_adam(obs, sh_s, D, D, g1, H1, B, on.w1, mu.w1, nu.w1, k);
    __syncthreads();

    // ---- scheduled target sync (dqn_update_kernel.py:197-203) -----------
    if ((n0 + u + 1) % sync_every == 0) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) tg.w1[i] = on.w1[i];
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) {
    *count_o = c0 + U;
    *upd_o = n0 + U;
    *loss_o = __fdiv_rn(loss_acc, (float)U);
  }
}

// Bytes of dynamic shared memory the launch uses: the batch row and the
// per-sample arrays, plus the three [B, max(H1, H2)] activation buffers
// unless `scratch` is given (then those live in device memory). Mirrored by
// ops/dqn_update_kernel.py::smem_bytes.
size_t dqn_update_smem(int B, int H1, int H2, int A, int with_big) {
  const size_t Hm = H1 > H2 ? H1 : H2;
  size_t words = (size_t)B * (5 + 3 * A + 2);
  if (with_big) words += 3 * (size_t)B * Hm;
  return words * 4;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). `state`
// holds the four parameter sets (params, target, μ, ν) packed back to back,
// P floats each as w1 [D, H1], b1, w2 [H1, H2], b2, w3 [H2, A], b3, and is
// updated in place. Indices must lie in [0, S), actions in [0, A).
extern "C" int dqn_update_launch(
    const void* obs, int D, int H1, int H2, int A, void* state,
    const void* count0, const void* upd0, const void* s_idx,
    const void* n_idx, const void* act, const void* rew, const void* done,
    int U, int B, float lr, float gamma_n, float beta1, float omb1,
    float beta2, float omb2, float eps, int sync_every, int double_q,
    void* scratch, void* count_o, void* upd_o, void* loss_o, void* stream) {
  const size_t smem = dqn_update_smem(B, H1, H2, A, scratch == nullptr);
  if (smem > kMaxSmem || B < 1 || U < 0 || sync_every < 1)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dqn_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int P = D * H1 + H1 + H1 * H2 + H2 + H2 * A + A;
  dqn_update_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)obs, D, H1, H2, A, (float*)state, P,
      (const int64_t*)count0, (const int64_t*)upd0, (const int32_t*)s_idx,
      (const int32_t*)n_idx, (const int32_t*)act, (const float*)rew,
      (const uint8_t*)done, U, B, lr, gamma_n, beta1, omb1, beta2, omb2, eps,
      sync_every, double_q, (float*)scratch, (int64_t*)count_o,
      (int64_t*)upd_o,
      (float*)loss_o);
  return (int)cudaGetLastError();
}
