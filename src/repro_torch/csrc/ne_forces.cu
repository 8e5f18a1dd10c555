// B3: scatter-fused neighbour-embedding forces.
//
// Replaces: src/repro/kernels/ne_forces/kernel.py, ne_forces_scatter_pallas
//   (body _ne_forces_scatter_kernel, force math _edge_wsum).
// On the main path it runs once per step over Y (70,000 x 2) with 64
//   neighbours per row in three segments: attraction over the HD list (32),
//   repulsion over the LD list (16), repulsion over the negatives (16).
//
// Per segment s and row b, with delta = y[nbr] - y[q], base = 1 + |delta|^2/alpha:
//   attraction: edge = coef / base * delta,                 wsum += coef / base
//   repulsion:  edge = coef * base^-(alpha+1) * (-delta),    wsum += coef * base^-alpha
//   scat_s[q] += sum_k edge;  scat_s[nbr] -= edge where the segment scatters back.
//
// Bound on the H100: bytes.  The index and coefficient arrays (36 MB) are
// read once; Y (560 KB) and the three (N, 2) fields stay in the 50 MB L2;
// the arithmetic is a few dozen flops and two transcendentals per edge.
//
// Determinism (two launches on the same inputs give bit-identical output):
// float atomics would sum each row in a run-dependent order, so the fields
// are accumulated as int64 fixed point, whose sum does not depend on order.
// Pass 1 computes every row's terms and the largest |term| of each segment
// (atomicMax on the float's bits, itself order-independent) and writes the
// wsums.  The segment's scale is then 2^(62 - e), where 2^e exceeds the
// largest |term| times the number of terms, so no row total can overflow;
// values within 2^-17 of the largest keep float32 precision.  Pass 2
// recomputes the terms and adds them with 64-bit integer atomics into
// (S, N, d) accumulators that stay in L2; pass 3 converts back to float32.
// A non-finite term sets a flag that turns the whole output into NaN.
// The price is reading the index and coefficient arrays twice.
//
// B5 and B7: edge-emitting forces, one kernel template in two input modes.
//
// B5 replaces src/repro/kernels/ne_forces/kernel.py, ne_forces_gather_pallas
//   (body _ne_forces_gather_kernel): index-taking and segmented, rows read
//   through x[clip(qid)] and x[clip(nbr_idx)].  On the scatter_fused=False
//   path it runs once per step with B3's three segments (K = 32 + 16 + 16)
//   and writes the edges of the first two only (emit_edges (T, T, F)).
// B7 replaces ne_forces_pallas (body _ne_forces_kernel): pre-gathered, one
//   segment (one mode) per launch on y (B, d) and nbr (B, K, d).  On the
//   gather_fused=False path it runs three times per step: attraction on
//   Y[hd] (K = 32), repulsion on Y[ld] (16) and on Y[neg] (16).
// Per segment s, row b: agg_s[b] = sum_k edge, wsum_s[b] = sum_k w-term,
//   edge_s[b, k] written where the segment emits; the caller symmetrises
//   (index_add_ of -edge), so these outputs are deterministic themselves.
//
// Bound on the H100: bytes.  The index, coefficient and edge arrays dominate
// (B5: 36 MB read, 27 MB of edges written; B7 also reads the gathered
// (B, K, d) rows); the arithmetic is B3's, a few dozen flops per edge.
//
// Design: one warp per row, lane k handles edges k, k + 32, ... with the
// shared edge_term, so edges are written coalesced (lane-contiguous) and agg
// and wsum are warp sums.  The TPU kernel's SMEM index slabs and
// double-buffered row DMAs have no counterpart: the per-lane loads of
// neighbour rows are served by L2, where the (N, d) embedding stays.
#include "common.cuh"

namespace {

constexpr int kMaxSeg = 4;
constexpr int kWarps = 8;

}  // namespace

// Mirrored field for field by the ctypes Structure in
// repro_torch/kernels/ne_forces/ops.py.
struct ForceArgs {
  const float* y;              // (N, D)
  int64_t n;
  const int* qid;              // (B,)
  int64_t b;
  const int* nbr;              // (B, K), K = sum of segment sizes
  const float* coef;           // (B, K)
  const float* alpha;          // device scalar
  float* wsum;                 // (S, B)
  unsigned int* max_bits;      // (S,) bits of the largest |term|
  int* nonfinite;              // (1,)
  unsigned long long* acc;     // (S, N, D) fixed point, zeroed
  float* out;                  // (S, N, D)
  int k;
  int n_seg;
  int seg_start[kMaxSeg];
  int seg_size[kMaxSeg];
  int seg_mode[kMaxSeg];       // 0 attraction, 1 repulsion
  int seg_back[kMaxSeg];       // scatter the reaction to the neighbour row
};

// Mirrored field for field by the ctypes Structure in
// repro_torch/kernels/ne_forces/ops.py.  Gathered mode (B5) sets x, qid and
// nbr_idx; pre-gathered mode (B7) sets y and nbr.
struct EdgeArgs {
  const float* x;              // (N, D) embedding, B5
  int64_t n;
  const int* qid;              // (B,), B5
  const int* nbr_idx;          // (B, K), B5
  const float* y;              // (B, D) query rows, B7
  const float* nbr;            // (B, K, D) neighbour rows, B7
  const float* coef;           // (B, K)
  const float* alpha;          // device scalar
  int64_t b;
  int k;
  int n_seg;
  int seg_start[kMaxSeg];
  int seg_size[kMaxSeg];
  int seg_mode[kMaxSeg];       // 0 attraction, 1 repulsion
  float* edge[kMaxSeg];        // (B, seg_size, D), null = not emitted
  float* agg;                  // (S, B, D)
  float* wsum;                 // (S, B)
};

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(repro::kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(repro::kFullMask, v, off));
  return v;
}

// The force term of one edge (the JAX package's _edge_wsum, per edge).
template <int D>
__device__ __forceinline__ float edge_term(int mode, float alpha,
                                           const float (&yq)[D],
                                           const float* __restrict__ yt,
                                           float coef, float (&edge)[D]) {
  float delta[D];
  float d2 = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    delta[c] = __ldg(yt + c) - yq[c];
    d2 += delta[c] * delta[c];
  }
  const float base = 1.f + d2 / alpha;
  if (mode == 0) {
    const float s = coef * (1.f / base);
#pragma unroll
    for (int c = 0; c < D; ++c) edge[c] = s * delta[c];
    return s;
  }
  const float logb = logf(base);
  const float s = coef * expf(-(alpha + 1.f) * logb);
#pragma unroll
  for (int c = 0; c < D; ++c) edge[c] = s * (-delta[c]);
  return coef * expf(-alpha * logb);
}

// Scale of segment s: 2^(62 - e) with 2^e > (largest |term|) x (#terms).
__device__ __forceinline__ double seg_scale(const ForceArgs& a, int s) {
  const double terms =
      static_cast<double>(a.b) * (a.seg_back[s] ? a.seg_size[s] + 1 : 1);
  const double bound =
      static_cast<double>(__uint_as_float(a.max_bits[s])) * terms;
  if (!(bound > 0.0) || isinf(bound)) return 1.0;
  int e;
  frexp(bound, &e);
  return ldexp(1.0, 62 - e);
}

__device__ __forceinline__ unsigned long long to_fixed(float v, double scale) {
  return static_cast<unsigned long long>(
      __double2ll_rn(static_cast<double>(v) * scale));
}

// kPass 1: wsums, per-segment term bound, non-finite flag.
// kPass 2: fixed-point accumulation of the terms.
template <int D, int kPass>
__global__ void __launch_bounds__(kWarps * 32)
    forces_rows_kernel(const ForceArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= a.b) return;  // uniform per warp
  const float alpha = *a.alpha;
  const int64_t q = repro::clamp_row(a.qid[r], a.n);
  float yq[D];
#pragma unroll
  for (int c = 0; c < D; ++c) yq[c] = a.y[q * D + c];
  bool bad = false;
  for (int s = 0; s < a.n_seg; ++s) {
    const bool back = a.seg_back[s] != 0;
    const double scale = kPass == 2 ? seg_scale(a, s) : 1.0;
    float agg[D];
#pragma unroll
    for (int c = 0; c < D; ++c) agg[c] = 0.f;
    float ws = 0.f, emax = 0.f;
    for (int i = lane; i < a.seg_size[s]; i += 32) {
      const int64_t j = r * a.k + a.seg_start[s] + i;
      const int64_t t = repro::clamp_row(a.nbr[j], a.n);
      float e[D];
      const float wt = edge_term<D>(a.seg_mode[s], alpha, yq, a.y + t * D,
                                    a.coef[j], e);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        agg[c] += e[c];
        if (kPass == 1) {
          emax = fmaxf(emax, fabsf(e[c]));
          bad = bad || !isfinite(e[c]);
        } else if (back) {
          atomicAdd(a.acc + (s * a.n + t) * D + c, to_fixed(-e[c], scale));
        }
      }
      ws += wt;
      if (kPass == 1) bad = bad || !isfinite(wt);
    }
#pragma unroll
    for (int c = 0; c < D; ++c) agg[c] = warp_sum(agg[c]);
    if (kPass == 1) {
      ws = warp_sum(ws);
      float m = back ? emax : 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        m = fmaxf(m, fabsf(agg[c]));
        bad = bad || !isfinite(agg[c]);
      }
      m = warp_max(m);
      if (lane == 0) {
        a.wsum[s * a.b + r] = ws;
        atomicMax(a.max_bits + s, __float_as_uint(m));
      }
    } else if (lane == 0) {
#pragma unroll
      for (int c = 0; c < D; ++c)
        atomicAdd(a.acc + (s * a.n + q) * D + c, to_fixed(agg[c], scale));
    }
  }
  if (kPass == 1 && __any_sync(repro::kFullMask, bad) && lane == 0)
    atomicOr(a.nonfinite, 1);
}

template <int D>
__global__ void forces_unpack_kernel(const ForceArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n_seg * a.n * D) return;
  if (*a.nonfinite) {
    a.out[i] = NAN;
    return;
  }
  const int s = static_cast<int>(i / (a.n * D));
  a.out[i] = static_cast<float>(
      static_cast<double>(static_cast<long long>(a.acc[i])) / seg_scale(a, s));
}

template <int D>
int launch(const ForceArgs& a, cudaStream_t stream) {
  if (a.b > 0) {
    const unsigned rows = static_cast<unsigned>((a.b + kWarps - 1) / kWarps);
    forces_rows_kernel<D, 1><<<rows, kWarps * 32, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    forces_rows_kernel<D, 2><<<rows, kWarps * 32, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total = a.n_seg * a.n * D;
  if (total > 0) {
    forces_unpack_kernel<D>
        <<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kGathered>
__global__ void __launch_bounds__(kWarps * 32)
    forces_edges_kernel(const EdgeArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= a.b) return;  // uniform per warp
  const float alpha = *a.alpha;
  const float* yrow =
      kGathered ? a.x + repro::clamp_row(a.qid[r], a.n) * D : a.y + r * D;
  float yq[D];
#pragma unroll
  for (int c = 0; c < D; ++c) yq[c] = yrow[c];
  for (int s = 0; s < a.n_seg; ++s) {
    const int size = a.seg_size[s];
    float* edge_out = a.edge[s];
    float agg[D];
#pragma unroll
    for (int c = 0; c < D; ++c) agg[c] = 0.f;
    float ws = 0.f;
    for (int i = lane; i < size; i += 32) {
      const int64_t j = r * a.k + a.seg_start[s] + i;
      const float* yt = kGathered
                            ? a.x + repro::clamp_row(a.nbr_idx[j], a.n) * D
                            : a.nbr + j * D;
      float e[D];
      ws += edge_term<D>(a.seg_mode[s], alpha, yq, yt, a.coef[j], e);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        agg[c] += e[c];
        if (edge_out != nullptr) edge_out[(r * size + i) * D + c] = e[c];
      }
    }
#pragma unroll
    for (int c = 0; c < D; ++c) agg[c] = warp_sum(agg[c]);
    ws = warp_sum(ws);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < D; ++c) a.agg[(s * a.b + r) * D + c] = agg[c];
      a.wsum[s * a.b + r] = ws;
    }
  }
}

template <int D>
int launch_edges(const EdgeArgs& a, cudaStream_t stream) {
  if (a.b > 0) {
    const unsigned rows = static_cast<unsigned>((a.b + kWarps - 1) / kWarps);
    if (a.x != nullptr) {
      forces_edges_kernel<D, true><<<rows, kWarps * 32, 0, stream>>>(a);
    } else {
      forces_edges_kernel<D, false><<<rows, kWarps * 32, 0, stream>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ne_forces_edges(const EdgeArgs* args, int d,
                                     cudaStream_t stream) {
  if (args->n_seg < 1 || args->n_seg > kMaxSeg) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 1: return launch_edges<1>(*args, stream);
    case 2: return launch_edges<2>(*args, stream);
    case 3: return launch_edges<3>(*args, stream);
    case 4: return launch_edges<4>(*args, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_ne_forces_scatter(const ForceArgs* args, int d,
                                       cudaStream_t stream) {
  if (args->n_seg < 1 || args->n_seg > kMaxSeg) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 1: return launch<1>(*args, stream);
    case 2: return launch<2>(*args, stream);
    case 3: return launch<3>(*args, stream);
    case 4: return launch<4>(*args, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
