// The squared-distance scoring of the lane and ring routes, shared by B1
// (pairwise_sqdist.cu) and B2/B4 (knn_merge.cu).  Both give, bit for bit,
// the value that common.cuh's warp_sqdist leaves in every lane, which the
// warp routes and B6 use as they are:
//
//  * lane_sqdist: one lane scores a pair of rows of at most kLaneM floats
//    alone (the LD rows at d = 2..8), so a warp scores 32 pairs at once
//    instead of reducing one pair over 32 lanes that the row cannot fill;
//  * ring_score: one warp scores a query row, held in registers, against
//    candidate rows of kRingMinM..kRingMaxM floats (M % 4 == 0, 16-byte
//    rows) that stream through a ring of `stages` whole rows in the warp's
//    shared memory, filled by the TMA's 1-D bulk copies, so the query row is
//    read once and `stages` candidate rows are in flight.
//
// The ring's block is kRingWarps = 4 warps; each kernel picks its stages.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int kLaneM = 8;      // the lane route's widest row
constexpr int kRingMinM = 128;     // the ring route's narrowest row
constexpr int kRingChunks = 8;     // float4s of the query row a lane holds
constexpr int kRingMaxM = 4 * 32 * kRingChunks;  // its widest, 1,024
constexpr int kRingWarps = 4;

// Scores the n rows row_of(0..n) of x (rows of m floats) against the query
// row (qv: lane holds its float4s lane, lane + 32, ...) through the warp's
// ring of `stages` whole rows: lane 0 keeps the ring filled by 1-D bulk
// copies, one mbarrier a stage, and refills a stage after the butterfly of
// the row it held, which every lane's reads of that stage precede; put(j,
// d) takes row j's distance in lane 0.  row_of runs in lane 0 only.  Each
// distance is warp_sqdist's bit for bit: the same chunks per lane in the
// same order, the same butterfly, and each chunk's sum rounded as nvcc
// compiles warp_sqdist's expression for sm_90a (dy * dy, fused
// multiply-adds of dx, dz, dw, then the add to the lane's sum; its SASS),
// written with intrinsics so that nothing here depends on how nvcc
// contracts it.
template <class RowOf, class Put>
__device__ __forceinline__ void ring_score(const float* x, int64_t m,
                                           float* ring, uint32_t bar0,
                                           int stages, int n,
                                           const float4 (&qv)[kRingChunks],
                                           int lane, RowOf row_of, Put put) {
  const int w = static_cast<int>(m), nv = w >> 2;
  const uint32_t bytes = 4u * static_cast<uint32_t>(w);
  const auto issue = [&](int j) {  // lane 0: row j into stage j % stages
    const int s = j % stages;
    hopper::mbar_expect_tx(bar0 + 8 * s, bytes);
    hopper::bulk_load(hopper::smem_u32(ring + s * w),
                      x + static_cast<int64_t>(row_of(j)) * m, bytes,
                      bar0 + 8 * s);
  };
  if (lane == 0) {
    for (int j = 0; j < n && j < stages; ++j) issue(j);
  }
  for (int j = 0; j < n; ++j) {
    const int s = j % stages;
    hopper::mbar_wait(bar0 + 8 * s, (j / stages) & 1);
    const float4* xc = reinterpret_cast<const float4*>(ring + s * w);
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kRingChunks; ++u) {
      if (lane + 32 * u < nv) {
        const float4 p = qv[u];
        const float4 v = xc[lane + 32 * u];
        const float dx = __fsub_rn(p.x, v.x), dy = __fsub_rn(p.y, v.y),
                    dz = __fsub_rn(p.z, v.z), dw = __fsub_rn(p.w, v.w);
        acc = __fadd_rn(acc, __fmaf_rn(dw, dw, __fmaf_rn(dz, dz, __fmaf_rn(
                                 dx, dx, __fmul_rn(dy, dy)))));
      }
    }
    for (int off = 16; off; off >>= 1)
      acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) {
      put(j, acc);
      if (j + stages < n) issue(j + stages);
    }
  }
  __syncwarp();
}

// ||xa - xb||^2 by one lane, for m <= kLaneM: bit for bit the value that
// warp_sqdist leaves in every lane.  There, part p of the row (a float, or
// a float4 when vec4) is lane p's sum, and the butterfly adds the lanes'
// sums in a fixed tree; lanes past the row hold exact zeros, so offsets 16
// and 8 change nothing and the tree over offsets 4, 2, 1 remains.  The
// explicit roundings keep nvcc from contracting a product into the next
// sum, which warp_sqdist does not do either.
__device__ __forceinline__ float lane_sqdist(const float* __restrict__ xa,
                                             const float* __restrict__ xb,
                                             int m, bool vec4) {
  float part[kLaneM];
#pragma unroll
  for (int p = 0; p < kLaneM; ++p) part[p] = 0.f;
  if (vec4) {
    const float4* va = reinterpret_cast<const float4*>(xa);
    const float4* vb = reinterpret_cast<const float4*>(xb);
#pragma unroll
    for (int p = 0; p < kLaneM / 4; ++p) {
      if (p < m / 4) {
        const float4 u = __ldg(va + p);
        const float4 w = __ldg(vb + p);
        const float dx = u.x - w.x, dy = u.y - w.y, dz = u.z - w.z,
                    dw = u.w - w.w;
        float acc = 0.f;
        acc += dx * dx + dy * dy + dz * dz + dw * dw;  // as warp_sqdist
        part[p] = acc;
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < kLaneM; ++p) {
      if (p < m) {
        const float d = __fsub_rn(__ldg(xa + p), __ldg(xb + p));
        part[p] = __fmul_rn(d, d);
      }
    }
  }
#pragma unroll
  for (int off = kLaneM / 2; off; off >>= 1) {
#pragma unroll
    for (int p = 0; p < off; ++p) part[p] = __fadd_rn(part[p], part[p + off]);
  }
  return part[0];
}

}  // namespace repro
