// B1: gathered squared distances, out[b, j] = ||x[clip(qid[b])] - x[clip(cand[b, j])]||^2.
//
// Replaces: src/repro/kernels/pairwise_sqdist/kernel.py,
//   pairwise_sqdist_gather_pallas (its scoring loop score_gather_block).
// On the main path it scores the initial neighbour lists in init_state:
//   X (70,000 x 784) with C = 32, and Y (70,000 x 2) with C = 16.
//
// Bound on the H100: bytes.  Each output needs two rows of x and a few
// flops per element (3 per column), far below the 295 flop/byte ridge.
// The least traffic is x read once plus the index and output arrays; the
// gathers actually touch (1 + C) rows per query, 7.2 GB for the HD call,
// and x (219.5 MB) does not fit the 50 MB L2, so they come from HBM.
//
// Design: three routes, chosen by the wrapper from the row width (as B2/B4's
// are; the scoring is row_sqdist.cuh's, shared with them):
//  * lanes, M <= kLaneM = 8 (the LD lists at d = 2, 5, 8): one thread per
//    (query, candidate) pair, lane_sqdist.  On the warp route a pair at
//    d = 2 costs a warp whose 30 other lanes idle and a five-step
//    butterfly; here consecutive threads take consecutive pairs, so the
//    ids are read and the distances written coalesced.
//  * ring, kRingMinM..kRingMaxM floats with M % 4 == 0 on a 16-byte-aligned
//    x (MNIST's 784): one warp per query row holds that row in registers and
//    streams its C candidate rows through ring_score's ring of
//    kGatherStages = 3 stages, so the query row is read once and not once
//    per candidate, and several candidate rows are in flight a warp.  Every
//    slot is scored, on its clipped id: there is no dedup here.
//  * warp, every other width (16, 32, 783, a misaligned x): one warp per
//    (query, candidate) pair, lanes striding over M with 16-byte loads
//    (warp_row_sqdist), so each warp reads its two rows as full coalesced
//    128-byte lines.
// All three give the same distances bit for bit.  The TPU kernel's SMEM
// index slabs and DMA double-buffering have no counterpart on the lane and
// warp routes: the many resident warps of each SM hide the load latency.
//
// B6: pre-gathered squared distances, out[b, j] = ||q[b] - c[b, j]||^2 for
// q (B, M) and c (B, C, M).
//
// Replaces: src/repro/kernels/pairwise_sqdist/kernel.py,
//   pairwise_sqdist_pallas (body _sqdist_kernel).
// On the gather_fused=False path it scores the HD candidates behind the
//   refinement gate: q = X[ids] (70,000 x 784) and c = X[cand] with C = 10
//   (14 with four reverse-edge slots).
//
// Bound on the H100: bytes.  Every input byte is used once (3 flops per
// float of c), so the least time is reading q and c once: 2.41 GB, 0.72 ms
// at 3.35 TB/s for C = 10.
//
// Design: B1's warp route, a warp per (query, candidate) pair and its
// reduction (warp_sqdist), reading c[b, j, :] in place of x[cand[b, j], :].
// The TPU kernel's grid axis over M, which carries the partial sum from one
// grid step to the next, becomes the lanes' stride loop inside the warp.
#include <cstdio>

#include "common.cuh"
#include "row_sqdist.cuh"

namespace {

__global__ void sqdist_gather_kernel(const float* __restrict__ x, int64_t n,
                                     int64_t m, const int* __restrict__ qid,
                                     const int* __restrict__ cand, int64_t b,
                                     int64_t c, float* __restrict__ out,
                                     bool vec4) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= b * c) return;  // uniform per warp
  const int64_t q = repro::clamp_row(qid[warp / c], n);
  const int64_t r = repro::clamp_row(cand[warp], n);
  const float d = repro::warp_row_sqdist(x, m, q, r, lane, vec4);
  if (lane == 0) out[warp] = d;
}

// The lane route: thread t scores pair t = b * C + j.  Idx is uint32_t
// where B * C allows it (a 64-bit division costs tens of instructions).
template <class Idx>
__global__ void sqdist_gather_lanes_kernel(const float* __restrict__ x,
                                           int64_t n, int64_t m,
                                           const int* __restrict__ qid,
                                           const int* __restrict__ cand,
                                           Idx total, Idx c,
                                           float* __restrict__ out, bool vec4) {
  const Idx t = static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t q = repro::clamp_row(qid[t / c], n);
  const int64_t r = repro::clamp_row(cand[t], n);
  out[t] = repro::lane_sqdist(x + q * m, x + r * m, static_cast<int>(m), vec4);
}

// The ring's stages a warp, at every C.  B1 scores every slot, with no
// list work between a warp's rows, so its ring needs a third stage where
// B2/B4's ring_stages keeps two (C <= 12): at merge_fused=False's C = 10,
// two stages ran 1.10x the warp route, three 0.85x (scripts/gather_ab.py).
constexpr int kGatherStages = 3;

// The ring route reads a query's candidate ids in chunks of kRingIds, which
// the warp's lanes copy, clipped, into shared memory before the chunk's
// rows are scored: lane 0 then takes each row's id from there when it
// refills a stage, and not from a global load that would stall the refill.
// A multiple of 2 x kGatherStages, so that a whole chunk leaves every
// stage's mbarrier at parity 0 for the next.
constexpr int kRingIds = 96;
static_assert(kRingIds % (2 * kGatherStages) == 0, "a chunk's parity");

// A warp's slice of the ring route's dynamic shared memory, in bytes:
// `stages` rows of m floats, their mbarriers and a chunk of ids, 16-byte
// aligned so that every warp's ring is.
__host__ __device__ constexpr int64_t ring_row_bytes(int64_t m, int stages) {
  return (stages * (4 * m + 8) + 4 * kRingIds + 15) / 16 * 16;
}

static_assert(repro::kRingWarps *
                      ring_row_bytes(repro::kRingMaxM, kGatherStages) <=
                  232448,
              "the ring route's block must fit a block's shared memory");

// The ring route: warp r scores query row r against its C candidates.
// `stages` is a kernel argument: with it a compile-time constant, nvcc
// spilled registers and the kernel ran slower (scripts/gather_ab.py).
__global__ void __launch_bounds__(repro::kRingWarps * 32)
    sqdist_gather_ring_kernel(const float* __restrict__ x, int64_t n,
                              int64_t m, const int* __restrict__ qid,
                              const int* __restrict__ cand, int64_t b, int c,
                              float* __restrict__ out, int stages) {
  extern __shared__ __align__(16) unsigned char ring_smem[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * repro::kRingWarps + w;
  if (r >= b) return;  // uniform per warp; no block-wide barrier follows
  const int nv = static_cast<int>(m) >> 2;
  unsigned char* mine = ring_smem + w * ring_row_bytes(m, stages);
  float* ring = reinterpret_cast<float*>(mine);
  const uint32_t bar0 = hopper::smem_u32(mine + 4 * stages * m);
  const float4* xq =
      reinterpret_cast<const float4*>(x + repro::clamp_row(qid[r], n) * m);
  float4 qv[repro::kRingChunks];
#pragma unroll
  for (int u = 0; u < repro::kRingChunks; ++u) {
    if (lane + 32 * u < nv) qv[u] = __ldg(xq + lane + 32 * u);
  }
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int* sched = reinterpret_cast<int*>(mine + stages * (4 * m + 8));
  for (int j0 = 0; j0 < c; j0 += kRingIds) {
    const int nj = min(c - j0, kRingIds);
    for (int g = lane; g < nj; g += 32) {
      sched[g] = static_cast<int>(repro::clamp_row(cand[r * c + j0 + g], n));
    }
    __syncwarp();
    float* dst = out + r * c + j0;
    repro::ring_score(x, m, ring, bar0, stages, nj, qv, lane,
                      [&](int j) { return sched[j]; },
                      [&](int j, float d) { dst[j] = d; });
  }
}

__global__ void sqdist_kernel(const float* __restrict__ q,
                              const float* __restrict__ c, int64_t b,
                              int64_t cc, int64_t m, float* __restrict__ out,
                              bool vec4) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= b * cc) return;  // uniform per warp
  const float d = repro::warp_sqdist(q + (warp / cc) * m, c + warp * m, m,
                                     lane, vec4);
  if (lane == 0) out[warp] = d;
}

}  // namespace

extern "C" int repro_pairwise_sqdist(const float* q, const float* c,
                                     int64_t b, int64_t cc, int64_t m,
                                     float* out, cudaStream_t stream) {
  if (b * cc > 0) {
    const int threads = 256;
    const int64_t blocks = (b * cc * 32 + threads - 1) / threads;
    sqdist_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        q, c, b, cc, m, out, repro::can_vec4(q, m) && repro::can_vec4(c, m));
  }
  return static_cast<int>(cudaGetLastError());
}

// B1, the warp route (every other width).
extern "C" int repro_pairwise_sqdist_gather(const float* x, int64_t n,
                                            int64_t m, const int* qid,
                                            const int* cand, int64_t b,
                                            int64_t c, float* out,
                                            cudaStream_t stream) {
  if (b * c > 0) {
    const int threads = 256;
    const int64_t blocks = (b * c * 32 + threads - 1) / threads;
    sqdist_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           stream>>>(x, n, m, qid, cand, b, c, out,
                                     repro::can_vec4(x, m));
  }
  return static_cast<int>(cudaGetLastError());
}

// B1, the lane route (m <= kLaneM).
extern "C" int repro_pairwise_sqdist_gather_lanes(const float* x, int64_t n,
                                                  int64_t m, const int* qid,
                                                  const int* cand, int64_t b,
                                                  int64_t c, float* out,
                                                  cudaStream_t stream) {
  if (m > repro::kLaneM) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = b * c;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks =
        static_cast<unsigned>((total + threads - 1) / threads);
    const bool vec4 = repro::can_vec4(x, m);
    if (total <= INT32_MAX) {  // t + 255 stays inside uint32_t
      sqdist_gather_lanes_kernel<uint32_t><<<blocks, threads, 0, stream>>>(
          x, n, m, qid, cand, static_cast<uint32_t>(total),
          static_cast<uint32_t>(c), out, vec4);
    } else {
      sqdist_gather_lanes_kernel<int64_t><<<blocks, threads, 0, stream>>>(
          x, n, m, qid, cand, total, c, out, vec4);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// B1, the ring route (128 <= m <= 1024, m % 4 == 0, x 16-byte aligned).
// Sizes the block itself.
extern "C" int repro_pairwise_sqdist_gather_ring(const float* x, int64_t n,
                                                 int64_t m, const int* qid,
                                                 const int* cand, int64_t b,
                                                 int64_t c, float* out,
                                                 cudaStream_t stream) {
  if (m < repro::kRingMinM || m > repro::kRingMaxM ||
      !repro::can_vec4(x, m) || c > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b * c > 0) {
    const int64_t smem =
        repro::kRingWarps * ring_row_bytes(m, kGatherStages);
    const cudaError_t err = cudaFuncSetAttribute(
        sqdist_gather_ring_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t blocks = (b + repro::kRingWarps - 1) / repro::kRingWarps;
    sqdist_gather_ring_kernel<<<static_cast<unsigned>(blocks),
                                repro::kRingWarps * 32,
                                static_cast<size_t>(smem), stream>>>(
        x, n, m, qid, cand, b, static_cast<int>(c), out, kGatherStages);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  static char msg[96];
  if (err == repro::kErrNoEncodeTiled)
    return "cuTensorMapEncodeTiled: no driver entry point";
  if (err == repro::kErrRegisterPool)
    return "kernel built with too few registers for its setmaxnreg split";
  if (err >= repro::kErrTensorMap) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the map: "
             "CUresult %d", err - repro::kErrTensorMap);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
