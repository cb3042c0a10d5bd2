// Staging into shared memory with cp.async, shared by the one-warp collect
// and rollout kernels that keep device memory out of a lane's step chain
// (dqn_kernel.cu, stoch_rollout_kernel.cu): a block of one warp copies its
// tables in once and its lanes' tiles of the [T, N] draw streams, kTile
// steps at a time, into double buffers, the next tile issued before the
// current one is walked.
#pragma once
#include <stddef.h>
#include <stdint.h>

namespace stage {

constexpr int kThreads = 32;  // one warp, one block
constexpr int kTile = 16;     // steps per stream tile

// n rounded up to 16: each staged array starts at a 16-byte boundary.
__host__ __device__ constexpr size_t r16(size_t n) { return (n + 15) & ~(size_t)15; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Issues the copy of n bytes from src into dst (16-byte aligned): 16 bytes
// a copy where src is 16-byte aligned, 4 where it is 4-byte aligned, the
// tail bytes by plain loads and stores (visible after the block's barrier).
__device__ inline void bytes(unsigned char* dst, const void* vsrc, size_t n) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(vsrc);
  const uintptr_t a = (uintptr_t)src;
  const size_t w = (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
  const size_t body = w == 1 ? 0 : n / w * w;
  for (size_t i = threadIdx.x * w; i < body; i += kThreads * w) {
    if (w == 16)
      cp_async16(dst + i, src + i);
    else
      cp_async4(dst + i, src + i);
  }
  for (size_t i = body + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// Issues the copies of the block's lanes [lane0, lane0 + n_live) of steps
// [s0, s0 + steps) of the [T, N] stream g into d ([step][lane], kThreads
// words a step). vec16: N % 4 == 0 and g 16-byte aligned.
__device__ __forceinline__ void stream(uint32_t* d, const uint32_t* g, int s0, int steps,
                                       int lane0, int n_live, int N, bool vec16) {
  if (vec16) {  // 8 copies of 16 bytes a full row, a row per 8 threads
    for (int c = threadIdx.x; c < steps * (kThreads / 4); c += kThreads) {
      const int row = c / (kThreads / 4), q = 4 * (c % (kThreads / 4));
      if (q < n_live) cp_async16(d + row * kThreads + q, g + (size_t)(s0 + row) * N + lane0 + q);
    }
  } else if ((int)threadIdx.x < n_live) {
    for (int row = 0; row < steps; ++row)
      cp_async4(d + row * kThreads + threadIdx.x,
                g + (size_t)(s0 + row) * N + lane0 + threadIdx.x);
  }
}

}  // namespace stage
