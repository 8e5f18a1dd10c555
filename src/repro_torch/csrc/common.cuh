// Device helpers shared by the port's kernels.
//
//  * The counter hash: the same lowbias32 arithmetic as repro.core.knn
//    (hash_mix / hash3 / counter_randint), on uint32_t, where unsigned
//    wraparound and logical shifts are the language's own semantics.
//  * warp_sqdist: the squared-distance reduction of two rows by one warp.
//    It is the one copy of the scoring stage, used through warp_row_sqdist
//    by pairwise_sqdist_gather (B1) and the candidate-fused merge (B2), as
//    score_gather_block is the one copy in the JAX package, and directly by
//    the pre-gathered pairwise_sqdist (B6).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFullMask = 0xffffffffu;

// Error codes of the C entries beyond cudaError_t's range (see
// repro_error_string): a TMA tensor map that cuTensorMapEncodeTiled refused
// (kErrTensorMap + its CUresult), no driver entry point for it, and a
// kernel whose register count leaves setmaxnreg short.
constexpr int kErrTensorMap = 1 << 20;
constexpr int kErrNoEncodeTiled = kErrTensorMap - 1;
constexpr int kErrRegisterPool = kErrTensorMap - 2;

__device__ __forceinline__ uint32_t hash_mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x21f0aaadu;
  h ^= h >> 15;
  h *= 0xd35a2d97u;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ uint32_t hash3(uint32_t salt, uint32_t row,
                                          uint32_t draw) {
  uint32_t h = hash_mix(salt ^ (row * 0x85ebca6bu));
  return hash_mix(h ^ (draw * 0xc2b2ae35u));
}

// Uniform integer in [0, bound) (31-bit mod), as knn.counter_randint.
__device__ __forceinline__ int counter_randint(uint32_t salt, uint32_t row,
                                               uint32_t draw, int bound) {
  return static_cast<int>((hash3(salt, row, draw) & 0x7fffffffu) %
                          static_cast<uint32_t>(bound));
}

__device__ __forceinline__ int64_t clamp_row(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// ||xa - xb||^2 over M floats, summed by one warp: the lanes stride over M
// (16-byte float4 loads when `vec4`, i.e. M % 4 == 0 and both rows 16-byte
// aligned) and a butterfly reduction leaves the full sum in every lane.  All
// 32 lanes must call it together.
__device__ __forceinline__ float warp_sqdist(const float* __restrict__ xa,
                                             const float* __restrict__ xb,
                                             int64_t m, int lane, bool vec4) {
  float acc = 0.f;
  if (vec4) {
    const float4* va = reinterpret_cast<const float4*>(xa);
    const float4* vb = reinterpret_cast<const float4*>(xb);
    for (int64_t i = lane; i < m / 4; i += 32) {
      const float4 p = __ldg(va + i);
      const float4 q = __ldg(vb + i);
      const float dx = p.x - q.x, dy = p.y - q.y, dz = p.z - q.z,
                  dw = p.w - q.w;
      acc += dx * dx + dy * dy + dz * dz + dw * dw;
    }
  } else {
    for (int64_t i = lane; i < m; i += 32) {
      const float d = __ldg(xa + i) - __ldg(xb + i);
      acc += d * d;
    }
  }
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  return acc;
}

// ||x[a] - x[b]||^2 for rows a and b of the row-major (N, M) matrix x.
__device__ __forceinline__ float warp_row_sqdist(const float* __restrict__ x,
                                                 int64_t m, int64_t a,
                                                 int64_t b, int lane,
                                                 bool vec4) {
  return warp_sqdist(x + a * m, x + b * m, m, lane, vec4);
}

inline bool can_vec4(const float* x, int64_t m) {
  return m % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace repro
