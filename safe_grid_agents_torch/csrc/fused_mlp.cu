// Actor-critic forward: h1 = tanh(x·w1 + b1), h2 = tanh(h1·w2 + b2),
// out = h2·wh + bh, all three layers in one kernel; h1 and h2 are written
// out for the backward.
//
// Replaces safe_grid_agents_tpu/ops/fused_mlp.py::_fwd_kernel (launched by
// _fwd_call through pl.pallas_call). The TPU kernel keeps all weights in
// VMEM (~16 MB) and runs 256-row blocks through three MXU products. Here a
// block of 256 threads takes 32 rows; each layer streams its weight matrix
// through shared memory in 16-row k-tiles (w1 alone is 196 KB at
// D_pad = 384, so no weight matrix is staged whole) and keeps the layer's
// output, 32 × 128 floats, in shared memory as the next layer's input.
// Thread t owns output column t % 128 of 16 rows and accumulates them in
// registers; a k-tile's weight row is read by neighbouring threads from
// neighbouring addresses and its input value is one broadcast per warp.
//
// What bounds it on this card: at B = 16,384 rows and D = 288 it does
// 2·B·(288·128 + 2·128·128) ≈ 2.3 GFLOP against ~44 MB of traffic (the
// input rows and three [B, 128] outputs), so on paper float32 operations
// bound it (~35 µs at 67 TFLOP/s) next to ~13 µs of bytes. This first
// design runs on the CUDA cores with a barrier per k-tile; tensor cores
// (TF32 would change the numbers) are later work.
//
// Numerics: each output is one thread's fmaf chain in k order, then the
// bias, then tanhf; the plain PyTorch version differs only in summation
// order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 128;                 // hidden and packed-head width
constexpr int kR = 32;                  // rows per block
constexpr int kKT = 16;                 // k-tile depth
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kR / (kThreads / kH);  // 16

// acc[i] = Σ_k in[(rg·16 + i)·ld + k] · W[k·kH + n] + bias[n] for the
// block's rows (rows at or past `rows` read as 0), k < K.
__device__ void dense(const float* in, int ld, int rows, int K,
                      const float* __restrict__ W,
                      const float* __restrict__ bias, float* xs, float* ws,
                      float acc[kRowsPerThread]) {
  const int n = threadIdx.x % kH;
  const int rg = threadIdx.x / kH;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();  // the previous tile (and any earlier layer) is done
    for (int c = threadIdx.x; c < kR * kKT; c += kThreads) {
      const int r = c / kKT, kk = c % kKT;
      xs[c] = (r < rows && k0 + kk < K) ? in[(size_t)r * ld + k0 + kk] : 0.f;
    }
    for (int c = threadIdx.x; c < kKT * kH; c += kThreads) {
      const int kk = c / kH;
      ws[c] = (k0 + kk < K) ? W[(size_t)(k0 + kk) * kH + c % kH] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      const float w = ws[kk * kH + n];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(xs[(rg * kRowsPerThread + i) * kKT + kk], w, acc[i]);
    }
  }
  const float b = bias[n];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = __fadd_rn(acc[i], b);
}

__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(
    const float* __restrict__ x, int B, int D, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ wh,
    const float* __restrict__ bh, float* __restrict__ out,
    float* __restrict__ h1_o, float* __restrict__ h2_o) {
  __shared__ float xs[kR * kKT];
  __shared__ float ws[kKT * kH];
  __shared__ float h1[kR * kH];
  __shared__ float h2[kR * kH];
  const int row0 = blockIdx.x * kR;
  const int rows = min(kR, B - row0);
  const int n = threadIdx.x % kH;
  const int rg = threadIdx.x / kH;
  float acc[kRowsPerThread];

  dense(x + (size_t)row0 * D, D, rows, D, w1, b1, xs, ws, acc);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg * kRowsPerThread + i;
    const float y = tanhf(acc[i]);
    h1[r * kH + n] = y;
    if (r < rows) h1_o[(size_t)(row0 + r) * kH + n] = y;
  }
  dense(h1, kH, kR, kH, w2, b2, xs, ws, acc);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg * kRowsPerThread + i;
    const float y = tanhf(acc[i]);
    h2[r * kH + n] = y;
    if (r < rows) h2_o[(size_t)(row0 + r) * kH + n] = y;
  }
  dense(h2, kH, kR, kH, wh, bh, xs, ws, acc);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg * kRowsPerThread + i;
    if (r < rows) out[(size_t)(row0 + r) * kH + n] = acc[i];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). x is
// [B, D]; w1 is [D_pad ≥ D, 128] of which the first D rows are read (the
// reference zero-pads x to D_pad, so the rest multiply zeros); w2 and wh
// are [128, 128], the biases [128]; out, h1_o, h2_o are [B, 128].
extern "C" int fused_mlp_launch(const void* x, int B, int D, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, const void* wh,
                                const void* bh, void* out, void* h1_o,
                                void* h2_o, void* stream) {
  if (B < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int blocks = (B + kR - 1) / kR;
  fused_mlp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, B, D, (const float*)w1, (const float*)b1,
      (const float*)w2, (const float*)b2, (const float*)wh, (const float*)bh,
      (float*)out, (float*)h1_o, (float*)h2_o);
  return (int)cudaGetLastError();
}
