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
// Design: one warp per (query, candidate) pair, lanes striding over M with
// 16-byte loads, so each warp reads its two rows as full coalesced 128-byte
// lines; the TPU kernel's SMEM index slabs and DMA double-buffering have no
// counterpart: the many resident warps of each SM hide the load latency.
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
// Design: B1's warp per (query, candidate) pair and its reduction
// (warp_sqdist), reading c[b, j, :] in place of x[cand[b, j], :].  The
// TPU kernel's grid axis over M, which carries the partial sum from one
// grid step to the next, becomes the lanes' stride loop inside the warp.
#include <cstdio>

#include "common.cuh"

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
