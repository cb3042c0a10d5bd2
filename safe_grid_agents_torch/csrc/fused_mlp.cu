// Actor-critic forward: h1 = tanh(x·w1 + b1), h2 = tanh(h1·w2 + b2),
// out = h2·wh + bh, all three layers in one kernel; h1 and h2 are written
// out for the backward.
//
// Replaces safe_grid_agents_tpu/ops/fused_mlp.py::_fwd_kernel (launched by
// _fwd_call through pl.pallas_call). The TPU kernel keeps all weights in
// VMEM (~16 MB) and runs 256-row blocks through three MXU products.
//
// What bounds it on this card: at B = 16,384 rows and D = 288 it does
// 2·B·(288·128 + 2·128·128) ≈ 2.3 GFLOP against ~44 MB of traffic (the
// input rows and three [B, 128] outputs). On the CUDA cores (the first
// design) that is ~35 µs of float32 operations at 67 TFLOP/s; on the tensor
// cores in 3xTF32 (three TF32 products per product, below) it is 6.8 GFLOP
// of TF32 work, ~14 µs at 495 TFLOP/s, next to ~13 µs of bytes.
//
// The Hopper design:
//  - the products run on the tensor cores, mma.sync.m16n8k8 with TF32
//    operands. TF32 alone keeps ~3 decimal digits, which would break the
//    forward's atol 1e-5, so each fp32 operand is split into hi = x rounded
//    to TF32 and lo = (x − hi) truncated to TF32, and a·b is accumulated in
//    fp32 as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b (3xTF32; the dropped lo·lo
//    term is ~2^-22 of the product). wgmma (warpgroup products from shared
//    memory) is a later route;
//  - persistent blocks, one per SM (217–223 KB of shared memory), each
//    walking row tiles tile = blockIdx.x, + gridDim.x, …;
//  - w2 and wh (2 × 64 KB) are staged into shared memory once per block and
//    kept; the first D rows of w1 stream with x through a cp.async ring of 3
//    or 4 k-tiles (Tile below; rows past D and past B zero-filled), and the
//    next tile's first k-tiles are issued before layers 2 and 3 of the
//    current one;
//  - h1 and h2 stay in shared memory between layers; bias and tanhf run in
//    each layer's epilogue, which also writes h1 and h2 out for the backward;
//  - the row tile is 64, 32 or 16 rows (row_tile below, mirrored by
//    ops/fused_mlp.py::geometry): the largest that still gives more than
//    n_sm / 2 tiles, so the collect's B = 1024 runs 64 tiles of 16 rows on
//    64 SMs and the update's B = 16,384 runs 256 tiles of 64 rows;
//  - 8 warps a block, each owning a (16·MT) × (8·NT) register tile of the
//    row tile × 128 outputs; shared-memory strides are padded so that the
//    fragment loads hit 32 distinct banks.
//
// Numerics: each output is an fp32 sum of 3xTF32 products in k order (the
// tensor core's fp32 accumulation), then the bias, then tanhf; the plain
// PyTorch version (fp32 matmuls) differs by rounding only, within atol 1e-5
// (tests/test_torch_fused_mlp_split.py models it on the CPU).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 128;         // hidden and packed-head width
constexpr int kThreads = 256;   // 8 warps
constexpr int kLdW = kH + 8;    // weight rows in shared memory: B fragments on 32 banks
constexpr int kLdH = kH + 4;    // activation tile rows: A fragments on 32 banks
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap
constexpr int kMaxDevices = 64;

// The row tile: the largest of 64 and 32 rows that still gives more than
// n_sm / 2 tiles, else 16.
__host__ __device__ inline int row_tile(int B, int n_sm) {
  if (2 * ((B + 63) / 64) > n_sm) return 64;
  if (2 * ((B + 31) / 32) > n_sm) return 32;
  return 16;
}

// What a row tile of M rows fixes. The 8 warps cover M rows × 128 columns
// as WM × WN warps, each MT m16 tiles × NT n8 tiles. Layer 1 streams x and
// w1 through a ring of STAGES k-tiles of KT rows of w1 (x tile rows padded
// to LDX floats: A fragments on 32 banks): as deep as the shared memory
// left beside w2, wh and the activation tile allows.
template <int M>
struct Tile {
  static constexpr int WM = M == 16 ? 1 : 2;
  static constexpr int WN = 8 / WM;
  static constexpr int MT = M / (16 * WM);
  static constexpr int NT = kH / (8 * WN);
  static constexpr int KT = M == 64 ? 16 : 32;
  static constexpr int STAGES = M == 32 ? 3 : 4;
  static constexpr int LDX = KT + 4;
  // Floats of shared memory: w2 and wh, the w1 and x rings, the activations.
  static constexpr size_t kFloats = 2 * (size_t)kH * kLdW + (size_t)STAGES * KT * kLdW +
                                    (size_t)STAGES * M * LDX + (size_t)M * kLdH;
};

__host__ __device__ inline size_t smem_bytes(int M) {
  return sizeof(float) * (M == 64 ? Tile<64>::kFloats
                                  : M == 32 ? Tile<32>::kFloats : Tile<16>::kFloats);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of an [R][C] tile from src (row stride lds floats) into
// dst (row stride ldd floats); rows at or past nr and columns at or past nc
// are zero-filled. vec: 16-byte copies (src 16-byte aligned, lds and nc
// multiples of 4 or nc >= C), else 4-byte ones.
template <int R, int C>
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src, size_t lds, int nr,
                                      int nc, bool vec) {
  if (vec) {
    constexpr int Q = C / 4;
    for (int c = threadIdx.x; c < R * Q; c += kThreads) {
      const int r = c / Q, q = 4 * (c % Q);
      const bool ok = r < nr && q < nc;
      cp_async16(dst + r * ldd + q, ok ? src + r * lds + q : src, ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < R * C; c += kThreads) {
      const int r = c / C, q = c % C;
      const bool ok = r < nr && q < nc;
      cp_async4(dst + r * ldd + q, ok ? src + r * lds + q : src, ok ? 4 : 0);
    }
  }
}

// x = hi + lo + rest: hi is x rounded to TF32 (to nearest, ties away from
// zero, on the bits), lo is x − hi (exact in fp32) truncated to TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(h))) & 0xffffe000u;
}

// d += a·b on the tensor cores: a 16×8 (row), b 8×8 (col), TF32 operands,
// fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mt][nt] += A·B over KS steps of 8 in 3xTF32: A [rows][k] in shared
// memory from the warp's first row (stride lda), B [k][n] from the warp's
// first column (stride ldb). Fragments (PTX m16n8k8 .tf32): a0 (g, t),
// a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (k=t, n=g), b1 (t+4, g), with
// g = lane / 4, t = lane % 4.
// With kSkipZeroLo, the lo_a·hi_b product of an m16 tile is skipped when lo
// is zero in the whole warp's fragment (x values that are TF32 already, such
// as the 0/1 observation planes): it would add exact zeros.
template <int MT, int NT, int KS, bool kSkipZeroLo>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][NT][4], const float* A, int lda,
                                         const float* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a = A + g * lda + t;
  const float* b = B + t * ldb + g;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = a + mt * 16 * lda + ks * 8;
      split(p[0], ahi[mt][0], alo[mt][0]);
      split(p[8 * lda], ahi[mt][1], alo[mt][1]);
      split(p[4], ahi[mt][2], alo[mt][2]);
      split(p[8 * lda + 4], ahi[mt][3], alo[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* p = b + ks * 8 * ldb + nt * 8;
      split(p[0], bhi[nt][0], blo[nt][0]);
      split(p[4 * ldb], bhi[nt][1], blo[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const bool lo = !kSkipZeroLo ||
                      __any_sync(0xffffffffu, alo[mt][0] | alo[mt][1] | alo[mt][2] | alo[mt][3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (lo) mma(acc[mt][nt], alo[mt], bhi[nt]);
        mma(acc[mt][nt], ahi[mt], blo[nt]);
        mma(acc[mt][nt], ahi[mt], bhi[nt]);
      }
    }
  }
}

// y = acc + bias (then tanhf): into the activation tile `hs` (if any) and,
// for rows below `rows`, into `gout` at row row0 + r; acc is zeroed for the
// next layer. Accumulators (PTX m16n8k8): c0 (g, 2t), c1 (g, 2t+1),
// c2 (g+8, 2t), c3 (g+8, 2t+1).
template <int MT, int NT, bool kTanh>
__device__ __forceinline__ void epilogue(float (&acc)[MT][NT][4], const float* __restrict__ bias,
                                         int wr0, int wc0, float* hs,
                                         float* __restrict__ gout, int row0, int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = wc0 + nt * 8 + 2 * t;
    const float bx = bias[c], by = bias[c + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr0 + mt * 16 + g + 8 * half;
        float2 y = make_float2(__fadd_rn(acc[mt][nt][2 * half], bx),
                               __fadd_rn(acc[mt][nt][2 * half + 1], by));
        if (kTanh) {
          y.x = tanhf(y.x);
          y.y = tanhf(y.y);
        }
        if (hs != nullptr) *reinterpret_cast<float2*>(hs + r * kLdH + c) = y;
        if (r < rows) *reinterpret_cast<float2*>(gout + (size_t)(row0 + r) * kH + c) = y;
        acc[mt][nt][2 * half] = 0.f;
        acc[mt][nt][2 * half + 1] = 0.f;
      }
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1) fused_mlp_kernel(
    const float* __restrict__ x, int B, int D, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ wh,
    const float* __restrict__ bh, float* __restrict__ out, float* __restrict__ h1_o,
    float* __restrict__ h2_o, int vec_x, int vec_w) {
  using G = Tile<M>;
  constexpr int S = G::STAGES, KT = G::KT, LDX = G::LDX;
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;                   // [128][kLdW]
  float* whs = w2s + kH * kLdW;        // [128][kLdW]
  float* w1r = whs + kH * kLdW;        // [S][KT][kLdW]
  float* xr = w1r + S * KT * kLdW;     // [S][M][LDX]
  float* hs = xr + S * M * LDX;        // [M][kLdH]
  const int warp = threadIdx.x >> 5;
  const int wr0 = (warp / G::WN) * G::MT * 16;  // the warp's first row of the tile
  const int wc0 = (warp % G::WN) * G::NT * 8;   // ... and first column
  const int tiles = (B + M - 1) / M;
  const int nkt = (D + KT - 1) / KT;
  float acc[G::MT][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // Issues k-tile kt of layer 1 of row tile `tile` (x columns and w1 rows
  // kt·KT … kt·KT + KT; past D zero-filled) into ring buffer kt % S. The
  // caller commits.
  auto issue = [&](int tile, int kt) {
    const int row0 = tile * M, k0 = kt * KT, buf = kt % S;
    stage<M, KT>(xr + buf * M * LDX, LDX, x + (size_t)row0 * D + k0, D, min(M, B - row0),
                 D - k0, vec_x);
    stage<KT, kH>(w1r + buf * KT * kLdW, kLdW, w1 + (size_t)k0 * kH, kH, D - k0, kH, vec_w);
  };
  // The first S − 1 k-tiles of `tile`, one commit group each (empty past
  // the last k-tile); on the block's first tile w2 and wh follow k-tile 0 as
  // their own group, so as not to delay it.
  auto prologue = [&](int tile, bool with_w) {
    for (int kt = 0; kt < S - 1; ++kt) {
      if (kt < nkt) issue(tile, kt);
      cp_async_commit();
      if (with_w && kt == 0) {
        stage<kH, kH>(w2s, kLdW, w2, kH, kH, kH, vec_w);
        stage<kH, kH>(whs, kLdW, wh, kH, kH, kH, vec_w);
        cp_async_commit();
      }
    }
  };

  if ((int)blockIdx.x >= tiles) return;
  prologue(blockIdx.x, true);
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * M, rows = min(M, B - row0);
    // Layer 1: x · w1[:D]. At k-tile kt the groups committed after its own
    // are kt + 1 … kt + S − 2 (and w2/wh at the first tile's k-tile 0).
    for (int kt = 0; kt < nkt; ++kt) {
      if (first && kt == 0)
        cp_async_wait<S - 1>();
      else
        cp_async_wait<S - 2>();
      __syncthreads();  // k-tile kt visible; every warp is done with k-tile kt − 1
      if (kt + S - 1 < nkt) issue(tile, kt + S - 1);  // into k-tile kt − 1's buffer
      cp_async_commit();
      const int buf = kt % S;
      mma_tile<G::MT, G::NT, KT / 8, true>(acc, xr + buf * M * LDX + wr0 * LDX, LDX,
                                           w1r + buf * KT * kLdW + wc0, kLdW);
    }
    if (first) cp_async_wait<0>();  // w2 and wh (the barrier below publishes them)
    epilogue<G::MT, G::NT, true>(acc, b1, wr0, wc0, hs, h1_o, row0, rows);
    __syncthreads();  // h1 complete; the ring is free
    if (tile + (int)gridDim.x < tiles)  // the next tile's first k-tiles, during layers 2-3
      prologue(tile + gridDim.x, false);
    mma_tile<G::MT, G::NT, kH / 8, false>(acc, hs + wr0 * kLdH, kLdH, w2s + wc0, kLdW);
    __syncthreads();  // every warp has read h1
    epilogue<G::MT, G::NT, true>(acc, b2, wr0, wc0, hs, h2_o, row0, rows);
    __syncthreads();  // h2 complete
    mma_tile<G::MT, G::NT, kH / 8, false>(acc, hs + wr0 * kLdH, kLdH, whs + wc0, kLdW);
    epilogue<G::MT, G::NT, false>(acc, bh, wr0, wc0, nullptr, out, row0, rows);
    first = false;
  }
}

template <int M>
int launch(const float* x, int B, int D, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* wh, const float* bh, float* buf, int grid,
           bool vec_x, bool vec_w, int dev, cudaStream_t stream) {
  static bool ready[kMaxDevices];  // the shared-memory attribute is set on this device
  const size_t smem = Tile<M>::kFloats * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (dev >= kMaxDevices || !ready[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  const size_t plane = (size_t)B * kH;
  fused_mlp_kernel<M><<<grid, kThreads, smem, stream>>>(
      x, B, D, w1, b1, w2, b2, wh, bh, buf, buf + plane, buf + 2 * plane, vec_x ? 1 : 0,
      vec_w ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// (row tile, tiles, grid, shared-memory bytes a block) for B rows on a card
// of n_sm SMs. Mirrored by ops/fused_mlp.py::geometry.
extern "C" void fused_mlp_geometry(int B, int n_sm, long long* out) {
  const int M = row_tile(B, n_sm);
  const int tiles = (B + M - 1) / M;
  out[0] = M;
  out[1] = tiles;
  out[2] = tiles < n_sm ? tiles : n_sm;
  out[3] = (long long)smem_bytes(M);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). x is
// [B, D]; w1 is [D_pad ≥ D, 128] of which the first D rows are read (the
// reference zero-pads x to D_pad, so the rest multiply zeros); w2 and wh
// are [128, 128], the biases [128]; `buf` is [3, B, 128]: out, h1, h2.
extern "C" int fused_mlp_launch(const void* x, int B, int D, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* wh, const void* bh,
                                void* buf, void* stream) {
  if (B < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int M = row_tile(B, n_sm);
  const int tiles = (B + M - 1) / M;
  const int grid = tiles < n_sm ? tiles : n_sm;
  const bool vec_x = D % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const bool vec_w = (((uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)wh) & 15) == 0;
  const float *xf = (const float*)x, *w1f = (const float*)w1, *b1f = (const float*)b1,
              *w2f = (const float*)w2, *b2f = (const float*)b2, *whf = (const float*)wh,
              *bhf = (const float*)bh;
  float* o = (float*)buf;
  cudaStream_t s = (cudaStream_t)stream;
  auto go = M == 64 ? launch<64> : M == 32 ? launch<32> : launch<16>;
  return go(xf, B, D, w1f, b1f, w2f, b2f, whf, bhf, o, grid, vec_x, vec_w, dev, s);
}
