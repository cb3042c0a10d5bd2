// Tiled products on the tensor cores for the grid-wide learner kernels
// (dqn_update_grid.cu, B4's route for wide nets and batches, and
// ppo_wide_kernel.cu, B6's route for wide nets), mirrored by
// ops/tile_gemm.py.
//
// A kernel of that kind runs one persistent block of kThreads threads per
// slot of the co-resident grid and walks its work phase by phase, with a
// grid barrier between dependent phases. Each phase is a list of Jobs, each
// job one product C[M, N] = Σ_k A(m, k)·B(k, n) cut into kBM × kBN output
// tiles; a job whose reduction is long (K > kKC, a sum over a batch) is cut
// into split-K parts of kKC rows, each written to its own slice of a
// partial buffer and joined in part order by a later phase. Every output
// element (or part of one) has ONE owner, which sums its k range in order:
// no float atomics, so a kernel is reproducible run to run.
//
// An operand X(i, k) (i = m for A, i = n for B) is read from a row-major
// matrix in device memory, with or without a row gather, either as stored
// (X(i, k) = p[row(i)·ld + k], contiguous in k) or transposed (X(i, k) =
// p[row(k)·ld + i], contiguous in i); `ones` names an index i that reads 1
// (the bias row: a product whose A carries it also sums B over k, i.e. the
// bias gradient). A k-chunk of kKT of both operands is copied into shared
// memory by cp.async in the operand's own order (an [i][k] tile for a
// stored operand, a [k][i] tile for a transposed one), four consecutive
// floats a copy: 16 bytes where the rows are 16-byte aligned, four 4-byte
// copies where they are not (odd widths), zero-filled past the edges; the
// copies of the next kStages − 1 chunks fly during the current chunk's
// products (a ring of kStages buffers in dynamic shared memory; two
// measured faster than four, tools/grid_variants.py). The products run on
// the tensor cores in 3xTF32 (mma.sync.m16n8k8, fragments read from either
// tile order): each fp32 operand is split into hi = x rounded to TF32 and
// lo = (x − hi) truncated to TF32, and a·b accumulates in fp32 as
// lo_a·hi_b + hi_a·lo_b + hi_a·hi_b, which keeps fp32-level accuracy (the
// dropped lo·lo term is ~2^-22 of the product). lo_a·hi_b is skipped where lo_a is zero in the
// whole warp's fragment (0/1 observation rows, the ones row, masked zeros).
// split and mma are those of fused_mlp.cu, whose copies stay in that file
// because tools/b11_variants.py edits its text.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tg {

constexpr int kThreads = 256;               // 8 warps
constexpr int kBlocksPerSm = 2;             // co-resident blocks an SM (the grid's size)
constexpr int kBM = 64, kBN = 64;           // output tile
constexpr int kKT = 32;                     // k-chunk staged in shared memory
constexpr int kKC = 512;                    // reduction rows of one split-K part
constexpr int kLdIK = kKT + 4;              // an [i][k] tile's row: fragments on 32 banks
constexpr int kMT = 2;                      // m16 tiles a warp: 32 rows
constexpr int kWarpsM = kBM / (16 * kMT);   // the 8 warps as kWarpsM × kWarpsN
constexpr int kWarpsN = kThreads / 32 / kWarpsM;
constexpr int kNT = kBN / (8 * kWarpsN);    // n8 tiles a warp
static_assert(kWarpsM * kWarpsN * 32 == kThreads && kNT >= 1, "the warps tile the output");

// A [k][i] tile's row for kBI rows of i (fragments on 32 banks), and the
// floats of one operand's chunk in either order.
__host__ __device__ constexpr int ld_ki(int bi) { return bi + 8; }
__host__ __device__ constexpr int slot_floats(int bi) {
  return bi * kLdIK > kKT * ld_ki(bi) ? bi * kLdIK : kKT * ld_ki(bi);
}
constexpr int kSlotA = slot_floats(kBM), kSlotB = slot_floats(kBN);
constexpr int kStages = 2;                  // chunks in the copy ring
constexpr int kSmemFloats = kStages * (kSlotA + kSlotB);  // the ring: both operands a chunk
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kKC % kKT == 0, "a split-K part is whole k-chunks");

// X(i, k) of a product's operand, 0 at i ≥ ni (except the ones row) and
// past the end of the k range a tile sums.
struct Opnd {
  const float* p;
  const int32_t* rows;  // gather: stored row of index r is rows[r] (nullptr: r)
  int ld;               // stored row stride (floats)
  int trans;            // 0: X(i, k) = p[row(i)·ld + k]; 1: X(i, k) = p[row(k)·ld + i]
  int ni;
  int ones;             // the index i that reads 1 (−1: none)
};

// What a tile does with its sums y = C[m, n] (m < M, n < N).
enum Epi : int {
  kStore = 0,  // out[(split·M + m)·ld + n] = y (a split-K part, or a plain product)
  kReluBias,   // out[m·ld + n] = max(y + bias[n], 0)
  kTanhBias,   // out[m·ld + n] = tanh(y + bias[n])
  kReluMask,   // out[m·ld + n] = aux[m·ld + n] > 0 ? y : 0 (the ReLU derivative)
  kTanhMask,   // out[m·ld + n] = y·(1 − aux[m·ld + n]²) (the tanh derivative)
};

struct Job {
  Opnd a, b;
  int M, N, K;
  int splits;  // split-K parts (kKC rows each); 1: the whole K in one tile
  int epi;
  float* out;
  int ld;
  const float* bias;
  const float* aux;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A scratch offset (floats) rounded up to a 16-byte boundary.
__host__ __device__ inline size_t r4(size_t x) { return (x + 3) & ~(size_t)3; }

// Split-K parts of a reduction of length K.
__host__ __device__ inline int parts(int K) { return K > kKC ? cdiv(K, kKC) : 1; }

__host__ __device__ inline int items(const Job& j) {
  return cdiv(j.M, kBM) * cdiv(j.N, kBN) * j.splits;
}

__host__ __device__ inline Job job(Opnd a, Opnd b, int M, int N, int K, bool split, int epi,
                                   float* out, int ld, const float* bias = nullptr,
                                   const float* aux = nullptr) {
  Job j;
  j.a = a;
  j.b = b;
  j.M = M;
  j.N = N;
  j.K = K;
  j.splits = split ? parts(K) : 1;
  j.epi = epi;
  j.out = out;
  j.ld = ld;
  j.bias = bias;
  j.aux = aux;
  return j;
}

__host__ __device__ inline Opnd opnd(const float* p, int ld, int trans, int ni,
                                     const int32_t* rows = nullptr, int ones = -1) {
  Opnd o;
  o.p = p;
  o.rows = rows;
  o.ld = ld;
  o.trans = trans;
  o.ni = ni;
  o.ones = ones;
  return o;
}

// The ones row's source (a copy can only read memory).
static __device__ __align__(16) float kOnes[4] = {1.f, 1.f, 1.f, 1.f};

// Copies one float from `from` to `dst`, or writes 0 if not `ok`.
__device__ __forceinline__ void copy1(float* dst, const float* from, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(ok ? from : kOnes), "r"(ok ? 4 : 0));
}

// Copies `n` (0..4) floats from `from` to `dst` and zero-fills the rest of
// the four: one 16-byte copy, or four 4-byte ones.
__device__ __forceinline__ void copy4(float* dst, const float* from, int n, bool vec) {
  if (vec) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(n > 0 ? from : kOnes), "r"(4 * n));
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) copy1(dst + q, from + q, q < n);
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of the kBI × kKT chunk (i0.., k0..) of an operand into
// the tile `s`: [i][k] (row kLdIK) if stored, [k][i] (row ld_ki(kBI)) if
// transposed; each thread takes groups of four floats along the stored
// rows, consecutive threads on consecutive groups. `vec`: the rows are
// 16-byte aligned (16-byte copies).
template <int kBI>
__device__ __forceinline__ void stage(const Opnd& o, int i0, int k0, int kend, bool vec,
                                      float* s) {
  static_assert(kBI * kKT % (4 * kThreads) == 0, "whole groups a thread");
#pragma unroll
  for (int q = 0; q < kBI * kKT / 4 / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (o.trans == 0) {  // four consecutive k of row i
      const int i = i0 + e / (kKT / 4), k = k0 + 4 * (e % (kKT / 4));
      float* dst = s + (i - i0) * kLdIK + (k - k0);
      const int n = min(4, max(0, kend - k));
      if (i == o.ones) {
        copy4(dst, kOnes, n, true);
      } else if (i >= o.ni) {
        copy4(dst, kOnes, 0, true);
      } else {
        const size_t r = o.rows ? (size_t)o.rows[i] : (size_t)i;
        copy4(dst, o.p + r * o.ld + k, n, vec);
      }
    } else {  // four consecutive i of row k
      const int k = k0 + e / (kBI / 4), i = i0 + 4 * (e % (kBI / 4));
      float* dst = s + (k - k0) * ld_ki(kBI) + (i - i0);
      if (k >= kend) {
        copy4(dst, kOnes, 0, true);
        continue;
      }
      const size_t r = o.rows ? (size_t)o.rows[k] : (size_t)k;
      const float* from = o.p + r * o.ld + i;
      const int n = min(4, max(0, o.ni - i));
      if (o.ones >= i && o.ones < i + 4) {  // the group holds the ones row
#pragma unroll
        for (int q2 = 0; q2 < 4; ++q2)
          copy1(dst + q2, i + q2 == o.ones ? kOnes : from + q2, i + q2 == o.ones || q2 < n);
      } else {
        copy4(dst, from, n, vec);
      }
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

// Element (i, k) of a staged tile of kBI rows in the order kTrans names.
template <bool kTrans, int kBI>
__device__ __forceinline__ float tile_at(const float* s, int i, int k) {
  return kTrans ? s[k * ld_ki(kBI) + i] : s[i * kLdIK + k];
}

// acc[mt][nt] += A·B over one k-chunk in 3xTF32, from the staged tiles of
// A (rows from the warp's first row wm0) and B (columns from wn0). The
// chunk's sums join acc in round-to-nearest fp32: the tensor core adds
// inside an mma with truncation, so a long reduction's error stays at
// fp32's level. Fragments (PTX m16n8k8 .tf32): a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); b0 (k=t, n=g), b1 (t+4, g), with g = lane / 4,
// t = lane % 4. lo_a·hi_b of an m16 tile is skipped when lo is zero in the
// whole warp's fragment: it would add exact zeros.
template <bool kTA, bool kTB>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMT][kNT][4], const float* As,
                                          const float* Bs, int wm0, int wn0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float part[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKT / 8; ++ks) {
    const int k = ks * 8 + t;
    uint32_t ahi[kMT][4], alo[kMT][4], bhi[kNT][2], blo[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int m = wm0 + mt * 16 + g;
      split(tile_at<kTA, kBM>(As, m, k), ahi[mt][0], alo[mt][0]);
      split(tile_at<kTA, kBM>(As, m + 8, k), ahi[mt][1], alo[mt][1]);
      split(tile_at<kTA, kBM>(As, m, k + 4), ahi[mt][2], alo[mt][2]);
      split(tile_at<kTA, kBM>(As, m + 8, k + 4), ahi[mt][3], alo[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = wn0 + nt * 8 + g;
      split(tile_at<kTB, kBN>(Bs, n, k), bhi[nt][0], blo[nt][0]);
      split(tile_at<kTB, kBN>(Bs, n, k + 4), bhi[nt][1], blo[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const bool lo = __any_sync(0xffffffffu, alo[mt][0] | alo[mt][1] | alo[mt][2] | alo[mt][3]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (lo) mma(part[mt][nt], alo[mt], bhi[nt]);
        mma(part[mt][nt], ahi[mt], blo[nt]);
        mma(part[mt][nt], ahi[mt], bhi[nt]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = __fadd_rn(acc[mt][nt][q], part[mt][nt][q]);
}

// The k loop of one tile: chunk c in ring slot c % kStages; the copies of
// chunks c + 1 … c + kStages − 1 are in flight while chunk c is multiplied.
template <bool kTA, bool kTB>
__device__ __forceinline__ void tile_sums(float (&acc)[kMT][kNT][4], const Opnd& a,
                                          const Opnd& b, bool va, bool vb, int m0, int n0,
                                          int k0, int k1, float* smem) {
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp / kWarpsN) * kMT * 16, wn0 = (warp % kWarpsN) * kNT * 8;
  const int chunks = cdiv(k1 - k0, kKT);
  auto issue = [&](int c) {  // one commit group a chunk (empty past the last)
    if (c < chunks) {
      float* slot = smem + (c % kStages) * (kSlotA + kSlotB);
      stage<kBM>(a, m0, k0 + c * kKT, k1, va, slot);
      stage<kBN>(b, n0, k0 + c * kKT, k1, vb, slot + kSlotA);
    }
    cp_async_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();  // ... for every thread; every warp is done with chunk c − 1
    issue(c + kStages - 1);  // into chunk c − 1's slot
    const float* As = smem + (c % kStages) * (kSlotA + kSlotB);
    mma_chunk<kTA, kTB>(acc, As, As + kSlotA, wm0, wn0);
  }
  __syncthreads();  // every warp is done with the ring before the next tile fills it
}

// Rows of the operand 16-byte aligned: 16-byte copies.
__device__ __forceinline__ bool aligned16(const Opnd& o) {
  return (o.ld & 3) == 0 && ((uintptr_t)o.p & 15) == 0;
}

// One output tile (tm, tn) of split-K part `split` of job j. Accumulators
// (PTX m16n8k8): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void run_tile(const Job& j, int split, int tm, int tn, float* smem) {
  const Opnd a = j.a, b = j.b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / kWarpsN) * kMT * 16, wn0 = (warp % kWarpsN) * kNT * 8;
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int k0 = j.splits > 1 ? split * kKC : 0;
  const int k1 = j.splits > 1 ? min(j.K, k0 + kKC) : j.K;
  const bool va = aligned16(a), vb = aligned16(b);
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  if (a.trans) {
    if (b.trans) tile_sums<true, true>(acc, a, b, va, vb, m0, n0, k0, k1, smem);
    else tile_sums<true, false>(acc, a, b, va, vb, m0, n0, k0, k1, smem);
  } else {
    if (b.trans) tile_sums<false, true>(acc, a, b, va, vb, m0, n0, k0, k1, smem);
    else tile_sums<false, false>(acc, a, b, va, vb, m0, n0, k0, k1, smem);
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm0 + mt * 16 + g + 8 * (q >> 1);
        const int n = n0 + wn0 + nt * 8 + 2 * t + (q & 1);
        if (m >= j.M || n >= j.N) continue;
        float y = acc[mt][nt][q];
        size_t o = (size_t)m * j.ld + n;
        switch (j.epi) {
          case kStore:
            o += (size_t)split * j.M * j.ld;
            break;
          case kReluBias:
            y = fmaxf(__fadd_rn(y, j.bias[n]), 0.f);
            break;
          case kTanhBias:
            y = tanhf(__fadd_rn(y, j.bias[n]));
            break;
          case kReluMask:
            y = j.aux[o] > 0.f ? y : 0.f;
            break;
          default: {  // kTanhMask
            const float x = j.aux[o];
            y = __fmul_rn(y, __fsub_rn(1.f, __fmul_rn(x, x)));
          }
        }
        j.out[o] = y;
      }
}

// Every tile of every job of a phase, spread over the grid: block b takes
// items b, b + gridDim.x, ... of the jobs' items laid end to end (job by
// job; within a job item = part · tiles + tile, so the blocks at work at
// once read the same k rows of the operands). `jobs` is in shared memory;
// each tile copies its operands' descriptions into registers.
template <int kJobs>
__device__ inline void run_phase(const Job (&jobs)[kJobs], int n_jobs, float* smem) {
  int total = 0;
  for (int q = 0; q < n_jobs; ++q) total += items(jobs[q]);
  for (int it = blockIdx.x; it < total; it += gridDim.x) {
    int q = 0, rest = it;
    while (rest >= items(jobs[q])) rest -= items(jobs[q++]);
    const Job& j = jobs[q];
    const int tiles = items(j) / j.splits;
    const int split = rest / tiles, tile = rest % tiles;
    const int tn_count = cdiv(j.N, kBN);
    run_tile(j, split, tile / tn_count, tile % tn_count, smem);
  }
}

// Σ over the parts of split-K job j of element (m, n), in part order.
__device__ __forceinline__ float join(const Job& j, int m, int n) {
  float acc = 0.f;
  const size_t plane = (size_t)j.M * j.ld;
  const float* p = j.out + (size_t)m * j.ld + n;
  for (int s = 0; s < j.splits; ++s) acc = __fadd_rn(acc, p[s * plane]);
  return acc;
}

// Launches `kernel` (one argument) cooperatively on `stream`: kBlocksPerSm
// blocks of kThreads on every SM of the current device, each with the copy
// ring in dynamic shared memory. Returns a CUDA error code (0 on success);
// cudaErrorCooperativeLaunchTooLarge if fewer blocks fit an SM.
template <class Args>
inline int launch(void (*kernel)(Args), const Args& a, cudaStream_t stream) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < kBlocksPerSm) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(n_sm * kBlocksPerSm), dim3(kThreads),
                                  args, kSmemBytes, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The job's report for the host mirror: M, N, K, parts.
__host__ inline void report(const Job& j, long long* out) {
  out[0] = j.M;
  out[1] = j.N;
  out[2] = j.K;
  out[3] = j.splits;
}

}  // namespace tg
