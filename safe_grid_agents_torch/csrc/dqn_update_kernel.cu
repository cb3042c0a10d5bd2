// DQN update: U sampled TD updates of a two-hidden-layer ReLU Q-net —
// forward passes of the online and target nets (double-Q optional), Huber
// loss, hand-derived backward, Adam and the scheduled target sync, update
// after update — on ONE thread-block cluster.
//
// Replaces safe_grid_agents_tpu/ops/dqn_update_kernel.py::_kernel (launched
// by dqn_update_run through pl.pallas_call). The TPU kernel reads the
// batch's observations through one-hot matmuls against a fold over all
// states, because Mosaic rejects row gathers; here each update gathers its
// B observation rows O[idx] straight from the [S, D] table.
//
// What bounds it on this card: update u+1 reads the parameters update u
// wrote, so the U updates are a serial chain of ~16–20 M float multiply-
// adds each (sokoban: D = 144, H = 128 × 128, B = 128), far too little to
// fill 132 SMs and too much for one. The first design ran the chain in one
// block on one SM and re-read the four parameter sets (params, target,
// Adam's μ and ν, 142 KB each) from L2 in every layer: ~0.6 ms per update,
// bound by one SM's latency. This design splits every layer's OUTPUT units
// over the C blocks of a cluster (C = 8, or 16 where 8 do not fit), so that:
//
//   * block r owns a column slice of w1 and of w2 (and the matching rows of
//     the head w3), with the same slice of the target, μ and ν: all four
//     parameter sets live in the cluster's shared memory for the whole
//     launch (~80 KB a block at sokoban), loaded once and written once;
//   * each forward computes the block's slice of x1 for all B rows; a block
//     then reads the full x1 rows of a row tile from its peers through
//     distributed shared memory, computes its slice of x2, and its partial
//     head sum Σ_{k in slice} x2·w3; the per-sample stage sums the C head
//     partials in rank order in every block (one cluster barrier per pass,
//     the x1 slices double-buffered between passes);
//   * backward: the head and w2's owned columns are local; ∂x1 = ∂x2·W2ᵀ
//     is formed as a per-block partial over the owned columns and summed
//     across the cluster in rank order, each block keeping its own slice;
//     the weight gradients of the owned slices go straight to Adam, element
//     by element, in the thread that summed them; the target sync is a
//     local copy.
//
// Products run on the CUDA cores (float32 FMA, register tiles of 8 rows,
// 16-byte shared-memory loads); about six cluster barriers per update.
//
// Numerics: every sum runs in a fixed order (each gradient element over the
// batch by one thread; the cross-block sums in rank order), no float
// atomics, so the kernel is reproducible run to run. Adam as optax.adam
// (μ = (1−β1)g + β1μ, ν = (1−β2)g² + β2ν, bias corrections 1 − βᵗ,
// p += −lr·μ̂/(√ν̂ + ε), no clip) in round-to-nearest intrinsics. The plain
// PyTorch version differs only in summation order (matmuls, autograd).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRB = 8;               // rows (or reduction outputs) per thread item
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory cap

// Phase stamps of update u (tools/trace_learners.py), compiled only with
// -DSGA_TRACE: a block barrier, then block 0's thread 0 records clock64().
// Without it SGA_STAMP is empty and the kernel is unchanged.
#ifdef SGA_TRACE
constexpr int kStampU = 256, kStampN = 16;
__device__ long long g_stamps[kStampU * kStampN];
#define SGA_STAMP(i)                                          \
  do {                                                        \
    __syncthreads();                                          \
    if (threadIdx.x == 0 && blockIdx.x == 0 && u < kStampU)   \
      g_stamps[u * kStampN + (i)] = clock64();                \
  } while (0)
#else
#define SGA_STAMP(i) \
  do {               \
  } while (0)
#endif

__host__ __device__ inline int r4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int r8(int x) { return (x + 7) & ~7; }
// A row stride for a slice read four columns at a time by consecutive rows'
// threads: a multiple of 4 that is not a multiple of 8, so that eight
// 16-byte loads of eight rows fall in distinct banks.
__host__ __device__ inline int conflict_free(int c) { return r4(c) % 8 ? r4(c) : r4(c) + 4; }

// Launch geometry, mirrored by ops/dqn_update_kernel.py::geometry.
struct Geo {
  int C, RB;              // cluster size, rows per row tile
  int c1, c2;             // owned slice width of layer 1, layer 2 (ceil(H / C))
  int ld1, ld2a, ld2p;    // strides: w1/x1 slices, x2 slice, w2 slice
  int ldx;                // row-tile stride (O rows, gathered x1, ∂x1 partial)
  int ps;                 // floats of one parameter set's slices
  int A4, B4, BA4, gacc;  // padded A, B, B·A; gradient accumulator floats
  size_t floats;
};

__host__ __device__ inline Geo make_geo(int D, int H1, int H2, int A, int B, int C, int RB) {
  Geo g;
  g.C = C;
  g.RB = RB;
  g.c1 = (H1 + C - 1) / C;
  g.c2 = (H2 + C - 1) / C;
  g.ld1 = r4(g.c1);
  g.ld2a = r4(g.c2);
  g.ld2p = conflict_free(g.c2);
  const int mx = D > H1 ? D : H1;
  g.ldx = r8(mx) + 4;
  g.A4 = r4(A);
  g.B4 = r4(B);
  g.BA4 = r4(B * A);
  g.ps = D * g.ld1 + g.ld1 + H1 * g.ld2p + g.ld2a + r4(g.c2 * A) + g.A4;
  int gacc = D * g.ld1;
  if (H1 * g.ld2a > gacc) gacc = H1 * g.ld2a;
  if (r4(g.c2 * A + A) > gacc) gacc = r4(g.c2 * A + A);
  g.gacc = gacc;
  g.floats = 4 * (size_t)g.ps + 5 * (size_t)g.B4 + 3 * (size_t)g.BA4 + 2 * (size_t)g.B4 +
             2 * (size_t)B * g.ld1 + (size_t)B * g.ld2a + (size_t)gacc +
             (size_t)RB * g.ldx;
  return g;
}

// The first (cluster size, row tile) that fits a block's shared memory, in
// order of preference; C = 0 if none does.
Geo choose_geo(int D, int H1, int H2, int A, int B) {
  const int cands[][2] = {{8, 128}, {8, 64}, {16, 128}, {16, 64}, {8, 32},
                          {16, 32}, {8, 16},  {16, 16},  {8, 8},   {16, 8}};
  for (const auto& cr : cands) {
    const int RB = cr[1] < r8(B) ? cr[1] : r8(B);
    Geo g = make_geo(D, H1, H2, A, B, cr[0], RB);
    if (g.floats * 4 <= kMaxSmem) return g;
  }
  Geo none = make_geo(D, H1, H2, A, B, 8, 8);
  none.C = 0;
  return none;
}

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

// out(r, n) = Σ_{k<K} X[r·ldx + k] · W(k, n) for r < R, n < N, handed to
// epi(r, n, sum). W(k, n) = W[k·ldw + n], or W[n·ldw + k] if TRANSW. Items
// of 8 rows × 1 column; k runs in order (four at a time: one 16-byte load
// per row, and per column one 16-byte load if TRANSW). X rows and, if
// TRANSW, W rows are 16-byte aligned (strides multiples of 4).
template <bool TRANSW, class Epi>
__device__ __forceinline__ void gemm(const float* X, int ldx, int R, int K,
                                     const float* W, int ldw, int N, Epi epi) {
  const int groups = (R + kRB - 1) / kRB;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int n = item % N, r0 = (item / N) * kRB;
    float acc[kRB];
    const float* xr[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      acc[i] = 0.f;
      xr[i] = X + (size_t)min(r0 + i, R - 1) * ldx;
    }
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      float w[4];
      if (TRANSW) {
        const float4 t = *reinterpret_cast<const float4*>(W + (size_t)n * ldw + k);
        w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = W[(size_t)(k + q) * ldw + n];
      }
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(xr[i] + k);
        acc[i] = fmaf(x.x, w[0], acc[i]);
        acc[i] = fmaf(x.y, w[1], acc[i]);
        acc[i] = fmaf(x.z, w[2], acc[i]);
        acc[i] = fmaf(x.w, w[3], acc[i]);
      }
    }
    for (; k < K; ++k) {
      const float w = TRANSW ? W[(size_t)n * ldw + k] : W[(size_t)k * ldw + n];
#pragma unroll
      for (int i = 0; i < kRB; ++i) acc[i] = fmaf(xr[i][k], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i)
      if (r0 + i < R) epi(r0 + i, n, acc[i]);
  }
}

// Weight gradient over a row tile: G[e·ldg + n] (+)= Σ_{r<R} X[r·ldx + e] ·
// Y[r·ldy + n] for e < E, n < N, each element summed over r in order by one
// thread, starting from 0 on the first tile and from G's value after it.
// Items of 8 consecutive e × 1 column; X rows are read 8 floats at a time
// (ldx a multiple of 4, at least r8(E)).
__device__ __forceinline__ void grad_tile(const float* X, int ldx, int E,
                                          const float* Y, int ldy, int N, int R,
                                          float* G, int ldg, bool first) {
  const int groups = (E + kRB - 1) / kRB;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int n = item % N, e0 = (item / N) * kRB;
    float acc[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i)
      acc[i] = (first || e0 + i >= E) ? 0.f : G[(size_t)(e0 + i) * ldg + n];
    for (int r = 0; r < R; ++r) {
      const float y = Y[(size_t)r * ldy + n];
      const float4 xa = *reinterpret_cast<const float4*>(X + (size_t)r * ldx + e0);
      const float4 xb = *reinterpret_cast<const float4*>(X + (size_t)r * ldx + e0 + 4);
      acc[0] = fmaf(xa.x, y, acc[0]);
      acc[1] = fmaf(xa.y, y, acc[1]);
      acc[2] = fmaf(xa.z, y, acc[2]);
      acc[3] = fmaf(xa.w, y, acc[3]);
      acc[4] = fmaf(xb.x, y, acc[4]);
      acc[5] = fmaf(xb.y, y, acc[5]);
      acc[6] = fmaf(xb.z, y, acc[6]);
      acc[7] = fmaf(xb.w, y, acc[7]);
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i)
      if (e0 + i < E) G[(size_t)(e0 + i) * ldg + n] = acc[i];
  }
}

// One parameter set's slices in shared memory.
struct Slice {
  float *w1, *b1, *w2, *b2, *w3, *b3;
};

__device__ Slice slice_at(float* base, const Geo& g, int D, int H1, int A) {
  Slice s;
  s.w1 = base;                    // [D][ld1]: w1[:, owned layer-1 units]
  s.b1 = s.w1 + D * g.ld1;        // [ld1]
  s.w2 = s.b1 + g.ld1;            // [H1][ld2p]: w2[:, owned layer-2 units]
  s.b2 = s.w2 + H1 * g.ld2p;      // [ld2a]
  s.w3 = s.b2 + g.ld2a;           // [c2][A]: w3[owned layer-2 units, :]
  s.b3 = s.w3 + r4(g.c2 * A);     // [A], the same in every block
  return s;
}

// Copies one parameter set's slices between the packed [P] vector in device
// memory (w1 [D, H1], b1, w2 [H1, H2], b2, w3 [H2, A], b3) and shared
// memory: `load` reads (zero in the pad columns), else writes (b3 from
// rank 0 only).
__device__ void move_slice(float* gp, const Slice& s, const Geo& g, int D, int H1,
                           int H2, int A, int j0, int n1, int k0, int n2, bool load,
                           bool rank0) {
  float* gw1 = gp;
  float* gb1 = gw1 + (size_t)D * H1;
  float* gw2 = gb1 + H1;
  float* gb2 = gw2 + (size_t)H1 * H2;
  float* gw3 = gb2 + H2;
  float* gb3 = gw3 + (size_t)H2 * A;
  for (int i = threadIdx.x; i < D * g.ld1; i += blockDim.x) {
    const int d = i / g.ld1, jj = i % g.ld1;
    if (load) s.w1[i] = jj < n1 ? gw1[(size_t)d * H1 + j0 + jj] : 0.f;
    else if (jj < n1) gw1[(size_t)d * H1 + j0 + jj] = s.w1[i];
  }
  for (int jj = threadIdx.x; jj < g.ld1; jj += blockDim.x) {
    if (load) s.b1[jj] = jj < n1 ? gb1[j0 + jj] : 0.f;
    else if (jj < n1) gb1[j0 + jj] = s.b1[jj];
  }
  for (int i = threadIdx.x; i < H1 * g.ld2p; i += blockDim.x) {
    const int j = i / g.ld2p, kk = i % g.ld2p;
    if (load) s.w2[i] = kk < n2 ? gw2[(size_t)j * H2 + k0 + kk] : 0.f;
    else if (kk < n2) gw2[(size_t)j * H2 + k0 + kk] = s.w2[i];
  }
  for (int kk = threadIdx.x; kk < g.ld2a; kk += blockDim.x) {
    if (load) s.b2[kk] = kk < n2 ? gb2[k0 + kk] : 0.f;
    else if (kk < n2) gb2[k0 + kk] = s.b2[kk];
  }
  for (int i = threadIdx.x; i < g.c2 * A; i += blockDim.x) {
    const int kk = i / A, a = i % A;
    if (load) s.w3[i] = kk < n2 ? gw3[(size_t)(k0 + kk) * A + a] : 0.f;
    else if (kk < n2) gw3[(size_t)(k0 + kk) * A + a] = s.w3[i];
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    if (load) s.b3[a] = gb3[a];
    else if (rank0) gb3[a] = s.b3[a];
  }
}

__global__ void __launch_bounds__(kThreads, 1) dqn_update_kernel(
    const float* __restrict__ obs, int D, int H1, int H2, int A, Geo g,
    float* __restrict__ state, int P, const int64_t* __restrict__ count0,
    const int64_t* __restrict__ upd0, const int32_t* __restrict__ s_idx,
    const int32_t* __restrict__ n_idx, const int32_t* __restrict__ act,
    const float* __restrict__ rew, const uint8_t* __restrict__ done, int U,
    int B, float lr, float gamma_n, float beta1, float omb1, float beta2,
    float omb2, float eps, int sync_every, int double_q,
    int64_t* __restrict__ count_o, int64_t* __restrict__ upd_o,
    float* __restrict__ loss_o) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = g.C;
  // Owned units: layer 1 [j0, j0 + n1), layer 2 [k0, k0 + n2) (maybe empty).
  const int j0 = min(rank * g.c1, H1), n1 = min(H1, j0 + g.c1) - j0;
  const int k0 = min(rank * g.c2, H2), n2 = min(H2, k0 + g.c2) - k0;

  extern __shared__ __align__(16) float smem[];
  float* at = smem;
  const Slice on = slice_at(at, g, D, H1, A);
  at += g.ps;
  const Slice tg = slice_at(at, g, D, H1, A);
  at += g.ps;
  const Slice mu = slice_at(at, g, D, H1, A);
  at += g.ps;
  const Slice nu = slice_at(at, g, D, H1, A);
  at += g.ps;
  int32_t* sh_s = reinterpret_cast<int32_t*>(at);
  int32_t* sh_n = sh_s + g.B4;
  int32_t* sh_a = sh_n + g.B4;
  float* sh_r = reinterpret_cast<float*>(sh_a + g.B4);
  int32_t* sh_d = reinterpret_cast<int32_t*>(sh_r + g.B4);
  float* qpart = reinterpret_cast<float*>(sh_d + g.B4);  // [3][B·A] head partials
  float* dqs = qpart + 3 * g.BA4;                         // [B] ∂loss/∂q_sa
  float* hub = dqs + g.B4;                                // [B] Huber losses
  float* x1s = hub + g.B4;                                // [2][B][ld1]; ∂x1 in place
  float* x2s = x1s + 2 * (size_t)B * g.ld1;               // [B][ld2a]; ∂x2 in place
  float* gacc = x2s + (size_t)B * g.ld2a;                 // gradient accumulators
  float* xbuf = gacc + g.gacc;                            // [RB][ldx] row tile

  for (int set = 0; set < 4; ++set) {
    const Slice& s = set == 0 ? on : set == 1 ? tg : set == 2 ? mu : nu;
    move_slice(state + (size_t)set * P, s, g, D, H1, H2, A, j0, n1, k0, n2, true, false);
  }
  const int64_t c0 = *count0, u0 = *upd0;
  const float inv_b = __fdiv_rn(1.f, (float)B);
  float loss_acc = 0.f;  // rank 0, thread 0: running Σ of per-update mean losses
  int pc = 0;            // passes so far: x1 slices alternate buffers by pass
  const int vec1 = (g.c1 % 4 == 0) && (H1 % 4 == 0);
  const int vecd = D % 4 == 0;
  cluster.sync();  // every block resident and loaded before any peer read

  // Stages rows[r0 .. r0+rb) of O into xbuf.
  auto stage_obs = [&](const int32_t* rows, int r0, int rb) {
    if (vecd) {
      const int D4 = D / 4;
      for (int i = threadIdx.x; i < rb * D4; i += blockDim.x) {
        const int r = i / D4, q = i % D4;
        *reinterpret_cast<float4*>(xbuf + (size_t)r * g.ldx + 4 * q) =
            *reinterpret_cast<const float4*>(obs + (size_t)rows[r0 + r] * D + 4 * q);
      }
    } else {
      for (int i = threadIdx.x; i < rb * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        xbuf[(size_t)r * g.ldx + d] = obs[(size_t)rows[r0 + r] * D + d];
      }
    }
  };
  // Gathers the full x1 rows [r0, r0+rb) of buffer `buf` from every block's
  // slice into xbuf (columns in unit order).
  auto gather_x1 = [&](int buf, int r0, int rb) {
    const float* mine = x1s + (size_t)buf * B * g.ld1;
    if (vec1) {
      const int H4 = H1 / 4, c4 = g.c1 / 4;
      for (int i = threadIdx.x; i < rb * H4; i += blockDim.x) {
        const int r = i / H4, q = i % H4, c = q / c4, jj = 4 * (q % c4);
        const float* src = cluster.map_shared_rank(mine, c);
        *reinterpret_cast<float4*>(xbuf + (size_t)r * g.ldx + 4 * q) =
            *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * g.ld1 + jj);
      }
    } else {
      for (int i = threadIdx.x; i < rb * H1; i += blockDim.x) {
        const int r = i / H1, j = i % H1, c = j / g.c1, jj = j % g.c1;
        const float* src = cluster.map_shared_rank(mine, c);
        xbuf[(size_t)r * g.ldx + j] = src[(size_t)(r0 + r) * g.ld1 + jj];
      }
    }
  };

  for (int u = 0; u < U; ++u) {
    SGA_STAMP(0);
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      const size_t o = (size_t)u * B + b;
      sh_s[b] = s_idx[o];
      sh_n[b] = n_idx[o];
      sh_a[b] = act[o];
      sh_r[b] = rew[o];
      sh_d[b] = done[o];
    }
    __syncthreads();

    SGA_STAMP(1);
    // ---- forward: target on s' (0), online on s' (1, double-Q), online on s (2)
    for (int pass = 0; pass < 3; ++pass) {
      if (pass == 1 && !double_q) continue;
      const Slice& net = pass == 0 ? tg : on;
      const int32_t* rows = pass == 2 ? sh_s : sh_n;
      const int buf = pc & 1;
      float* x1 = x1s + (size_t)buf * B * g.ld1;
      for (int r0 = 0; r0 < B; r0 += g.RB) {
        const int rb = min(g.RB, B - r0);
        stage_obs(rows, r0, rb);
        __syncthreads();
        gemm<false>(xbuf, g.ldx, rb, D, net.w1, g.ld1, n1, [&](int r, int n, float y) {
          x1[(size_t)(r0 + r) * g.ld1 + n] = fmaxf(__fadd_rn(y, net.b1[n]), 0.f);
        });
        __syncthreads();
      }
      if (pass == 2) SGA_STAMP(2);
      cluster.sync();  // every block's x1 slice of this pass is written
      if (pass == 2) SGA_STAMP(3);
      float* qp = qpart + pass * g.BA4;
      for (int r0 = 0; r0 < B; r0 += g.RB) {
        const int rb = min(g.RB, B - r0);
        gather_x1(buf, r0, rb);
        __syncthreads();
        gemm<false>(xbuf, g.ldx, rb, H1, net.w2, g.ld2p, n2, [&](int r, int n, float y) {
          x2s[(size_t)(r0 + r) * g.ld2a + n] = fmaxf(__fadd_rn(y, net.b2[n]), 0.f);
        });
        __syncthreads();
      }
      if (pass == 2) SGA_STAMP(4);
      // This block's head partial Σ_{k owned} x2[b, k]·w3[k, a].
      for (int i = threadIdx.x; i < B * A; i += blockDim.x) {
        const int b = i / A, a = i % A;
        float acc = 0.f;
        for (int kk = 0; kk < n2; ++kk)
          acc = fmaf(x2s[(size_t)b * g.ld2a + kk], net.w3[kk * A + a], acc);
        qp[i] = acc;
      }
      ++pc;
    }
    const int last = (pc - 1) & 1;  // the buffer of the online pass on s
    float* x1 = x1s + (size_t)last * B * g.ld1;
    cluster.sync();  // every block's head partials are written

    SGA_STAMP(5);
    // ---- per sample: Q from the partials in rank order, bootstrap, Huber
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      auto qsum = [&](int pass, int a, const float* bias) {
        float acc = 0.f;
        for (int c = 0; c < C; ++c) {
          const float* qp = cluster.map_shared_rank(qpart + pass * g.BA4, c);
          acc = __fadd_rn(acc, qp[b * A + a]);
        }
        return __fadd_rn(acc, bias[a]);
      };
      float boot;
      if (double_q) {  // the online net picks a* (first max), the target values it
        int astar = 0;
        float m = qsum(1, 0, on.b3);
        for (int a = 1; a < A; ++a) {
          const float qa = qsum(1, a, on.b3);
          if (qa > m) { m = qa; astar = a; }
        }
        boot = qsum(0, astar, tg.b3);
      } else {
        boot = qsum(0, 0, tg.b3);
        for (int a = 1; a < A; ++a) boot = fmaxf(boot, qsum(0, a, tg.b3));
      }
      const float target =
          __fadd_rn(sh_r[b], __fmul_rn(gamma_n, sh_d[b] ? 0.f : boot));
      const float diff = __fsub_rn(qsum(2, sh_a[b], on.b3), target);
      const float ad = fabsf(diff);
      const float quad = fminf(ad, 1.f);
      hub[b] = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, quad), quad), __fsub_rn(ad, quad));
      dqs[b] = __fmul_rn(fminf(fmaxf(diff, -1.f), 1.f), inv_b);
    }
    __syncthreads();
    if (rank == 0 && threadIdx.x == 0) {
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

    SGA_STAMP(6);
    // ---- head gradients (owned rows of w3; b3 alike in every block) -----
    for (int i = threadIdx.x; i < n2 * A + A; i += blockDim.x) {
      float gsum = 0.f;
      if (i < n2 * A) {
        const int kk = i / A, a = i % A;
        for (int b = 0; b < B; ++b)
          if (sh_a[b] == a) gsum = fmaf(x2s[(size_t)b * g.ld2a + kk], dqs[b], gsum);
      } else {
        const int a = i - n2 * A;
        for (int b = 0; b < B; ++b)
          if (sh_a[b] == a) gsum = __fadd_rn(gsum, dqs[b]);
      }
      gacc[i] = gsum;
    }
    __syncthreads();
    // ∂x2 (masked by x2 > 0) with the OLD w3, in place of x2.
    for (int i = threadIdx.x; i < B * n2; i += blockDim.x) {
      const int b = i / n2, kk = i % n2;
      float* x = x2s + (size_t)b * g.ld2a + kk;
      *x = *x > 0.f ? __fmul_rn(dqs[b], on.w3[kk * A + sh_a[b]]) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n2 * A + A; i += blockDim.x) {
      if (i < n2 * A) adam_step(on.w3, mu.w3, nu.w3, i, gacc[i], k);
      else adam_step(on.b3, mu.b3, nu.b3, i - n2 * A, gacc[i], k);
    }
    for (int kk = threadIdx.x; kk < n2; kk += blockDim.x) {
      float gsum = 0.f;
      for (int b = 0; b < B; ++b) gsum = __fadd_rn(gsum, x2s[(size_t)b * g.ld2a + kk]);
      adam_step(on.b2, mu.b2, nu.b2, kk, gsum, k);
    }
    __syncthreads();

    SGA_STAMP(7);
    // ---- gW2[:, owned] = x1ᵀ·∂x2 over the full x1 rows (peers' slices) ---
    for (int r0 = 0; r0 < B; r0 += g.RB) {
      const int rb = min(g.RB, B - r0);
      gather_x1(last, r0, rb);
      __syncthreads();
      grad_tile(xbuf, g.ldx, H1, x2s + (size_t)r0 * g.ld2a, g.ld2a, n2, rb, gacc, g.ld2a,
                r0 == 0);
      __syncthreads();
    }
    SGA_STAMP(8);
    // ---- ∂x1 = ∂x2·W2ᵀ (OLD w2): per-block partials over the owned columns,
    // summed across the cluster in rank order, masked by x1 > 0, in place.
    for (int r0 = 0; r0 < B; r0 += g.RB) {
      const int rb = min(g.RB, B - r0);
      gemm<true>(x2s + (size_t)r0 * g.ld2a, g.ld2a, rb, n2, on.w2, g.ld2p, H1,
                 [&](int r, int j, float y) { xbuf[(size_t)r * g.ldx + j] = y; });
      cluster.sync();  // every block's partial of this tile is written
      for (int i = threadIdx.x; i < rb * n1; i += blockDim.x) {
        const int r = i / n1, jj = i % n1;
        float acc = 0.f;
        for (int c = 0; c < C; ++c) {
          const float* part = cluster.map_shared_rank(xbuf, c);
          acc = __fadd_rn(acc, part[(size_t)r * g.ldx + j0 + jj]);
        }
        float* x = x1 + (size_t)(r0 + r) * g.ld1 + jj;
        *x = *x > 0.f ? acc : 0.f;
      }
      cluster.sync();  // every block has read the partials
    }
    SGA_STAMP(9);
    for (int i = threadIdx.x; i < H1 * n2; i += blockDim.x) {
      const int j = i / n2, kk = i % n2;
      adam_step(on.w2, mu.w2, nu.w2, j * g.ld2p + kk, gacc[(size_t)j * g.ld2a + kk], k);
    }
    for (int jj = threadIdx.x; jj < n1; jj += blockDim.x) {
      float gsum = 0.f;
      for (int b = 0; b < B; ++b) gsum = __fadd_rn(gsum, x1[(size_t)b * g.ld1 + jj]);
      adam_step(on.b1, mu.b1, nu.b1, jj, gsum, k);
    }
    __syncthreads();

    SGA_STAMP(10);
    // ---- gW1[:, owned] = O[s]ᵀ·∂x1 --------------------------------------
    for (int r0 = 0; r0 < B; r0 += g.RB) {
      const int rb = min(g.RB, B - r0);
      stage_obs(sh_s, r0, rb);
      __syncthreads();
      grad_tile(xbuf, g.ldx, D, x1 + (size_t)r0 * g.ld1, g.ld1, n1, rb, gacc, g.ld1,
                r0 == 0);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < D * n1; i += blockDim.x) {
      const int d = i / n1, jj = i % n1;
      adam_step(on.w1, mu.w1, nu.w1, d * g.ld1 + jj, gacc[(size_t)d * g.ld1 + jj], k);
    }
    __syncthreads();

    SGA_STAMP(11);
    // ---- scheduled target sync (dqn_update_kernel.py:197-203): local ----
    if ((u0 + u + 1) % sync_every == 0) {
      for (int i = threadIdx.x; i < g.ps; i += blockDim.x) tg.w1[i] = on.w1[i];
      __syncthreads();
    }
    SGA_STAMP(12);
  }
  cluster.sync();  // no block leaves while a peer may still read its memory
  for (int set = 0; set < 4; ++set) {
    const Slice& s = set == 0 ? on : set == 1 ? tg : set == 2 ? mu : nu;
    move_slice(state + (size_t)set * P, s, g, D, H1, H2, A, j0, n1, k0, n2, false,
               rank == 0);
  }
  if (rank == 0 && threadIdx.x == 0) {
    *count_o = c0 + U;
    *upd_o = u0 + U;
    *loss_o = __fdiv_rn(loss_acc, (float)U);
  }
}

}  // namespace

#ifdef SGA_TRACE
// Copies the first n stamps ([update][phase], kStampN a row) to `host`.
extern "C" int dqn_update_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * sizeof(long long));
}
#endif

// The launch geometry for these shapes: out = {cluster size, rows per row
// tile, shared-memory bytes per block}; cluster size 0 if none fits.
// Mirrored by ops/dqn_update_kernel.py::geometry.
extern "C" void dqn_update_geometry(int D, int H1, int H2, int A, int B, long long* out) {
  const Geo g = choose_geo(D, H1, H2, A, B);
  out[0] = g.C;
  out[1] = g.RB;
  out[2] = (long long)(g.floats * 4);
}

// Launch on `stream`; returns a CUDA error code (0 on success). `state`
// holds the four parameter sets (params, target, μ, ν) packed back to back,
// P floats each as w1 [D, H1], b1, w2 [H1, H2], b2, w3 [H2, A], b3, and is
// updated in place. Indices must lie in [0, S), actions in [0, A).
// The cluster has 8 blocks where they fit, else 16 (choose_geo).
extern "C" int dqn_update_launch(
    const void* obs, int D, int H1, int H2, int A, void* state,
    const void* count0, const void* upd0, const void* s_idx,
    const void* n_idx, const void* act, const void* rew, const void* done,
    int U, int B, float lr, float gamma_n, float beta1, float omb1,
    float beta2, float omb2, float eps, int sync_every, int double_q,
    void* count_o, void* upd_o, void* loss_o, void* stream) {
  if (B < 1 || U < 0 || A < 1 || D < 1 || H1 < 1 || H2 < 1 || sync_every < 1)
    return (int)cudaErrorInvalidValue;
  const Geo g = choose_geo(D, H1, H2, A, B);
  if (g.C == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = g.floats * 4;
  cudaError_t e = cudaFuncSetAttribute(
      dqn_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (g.C > 8) {
    e = cudaFuncSetAttribute(dqn_update_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&n_clusters, dqn_update_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (n_clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  const int P = D * H1 + H1 + H1 * H2 + H2 + H2 * A + A;
  e = cudaLaunchKernelEx(
      &cfg, dqn_update_kernel, (const float*)obs, D, H1, H2, A, g, (float*)state, P,
      (const int64_t*)count0, (const int64_t*)upd0, (const int32_t*)s_idx,
      (const int32_t*)n_idx, (const int32_t*)act, (const float*)rew,
      (const uint8_t*)done, U, B, lr, gamma_n, beta1, omb1, beta2, omb2, eps,
      sync_every, double_q, (int64_t*)count_o, (int64_t*)upd_o, (float*)loss_o);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
