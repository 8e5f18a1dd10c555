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
// Width: d = 1..4, 8, 16 and 32 (the main path's 2, the latents pipeline's
// 8, the dry run's 32) run a compile-time width held in registers; any
// other d runs the same kernels with a runtime width in tiles of 4 columns
// (Width<0>), which re-sums each edge's |delta|^2 once per tile.
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
// shared edge_scalars, so edges are written coalesced (lane-contiguous) and agg
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

// The per-edge scalars of the force (the JAX package's _edge_wsum): with
// base = 1 + d2/alpha the edge is s * delta (attraction) or s * (-delta)
// (repulsion); the return value is the edge's wsum term.
__device__ __forceinline__ float edge_scalars(int mode, float alpha, float d2,
                                              float coef, float& s) {
  const float base = 1.f + d2 / alpha;
  if (mode == 0) {
    s = coef * (1.f / base);
    return s;
  }
  const float logb = logf(base);
  s = coef * expf(-(alpha + 1.f) * logb);
  return coef * expf(-alpha * logb);
}

__device__ __forceinline__ float edge_comp(int mode, float s, float delta) {
  return mode == 0 ? s * delta : s * (-delta);
}

// Width of the embedding.  D > 0 is a compile-time width held in registers
// as one tile (the main path, d = 2).  D = 0 is any runtime width d >= 1,
// walked in tiles of kTile columns: each edge's |delta|^2 is summed over
// the whole row once per tile, and a tile's columns are accumulated as the
// fixed-width path accumulates all of them.
constexpr int kTile = 4;

template <int D>
struct Width {
  static constexpr int kT = D > 0 ? D : kTile;
  int d;
  __device__ __forceinline__ int cols() const { return D > 0 ? D : d; }
  __device__ __forceinline__ int tile(int c0) const {
    return D > 0 ? D : min(kTile, d - c0);
  }
};

// |delta|^2 of one edge and the tile [c0, c0 + w) of delta.  With D > 0
// the tile is the whole row and yq holds it; with D = 0 the row sum reads
// both rows (L1/L2-resident) and yq holds the tile only.
template <int D>
__device__ __forceinline__ float edge_delta(const Width<D>& wd, int c0, int w,
                                            const float* __restrict__ yq_row,
                                            const float (&yq)[Width<D>::kT],
                                            const float* __restrict__ yt,
                                            float (&delta)[Width<D>::kT]) {
  float d2 = 0.f;
  if constexpr (D > 0) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      delta[c] = __ldg(yt + c) - yq[c];
      d2 += delta[c] * delta[c];
    }
  } else {
    for (int c = 0; c < wd.d; ++c) {
      const float dl = __ldg(yt + c) - __ldg(yq_row + c);
      d2 += dl * dl;
    }
#pragma unroll
    for (int c = 0; c < kTile; ++c)
      delta[c] = c < w ? __ldg(yt + c0 + c) - yq[c] : 0.f;
  }
  return d2;
}

template <int D>
__device__ __forceinline__ void load_tile(const Width<D>& wd, int c0, int w,
                                          const float* __restrict__ yq_row,
                                          float (&yq)[Width<D>::kT]) {
#pragma unroll
  for (int c = 0; c < Width<D>::kT; ++c)
    yq[c] = c < w ? yq_row[c0 + c] : 0.f;
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
    forces_rows_kernel(const ForceArgs a, const Width<D> wd) {
  constexpr int kT = Width<D>::kT;
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= a.b) return;  // uniform per warp
  const float alpha = *a.alpha;
  const int dd = wd.cols();
  const int64_t q = repro::clamp_row(a.qid[r], a.n);
  const float* yq_row = a.y + q * dd;
  float yq[kT];
  if constexpr (D > 0) load_tile(wd, 0, D, yq_row, yq);
  bool bad = false;
  for (int s = 0; s < a.n_seg; ++s) {
    const bool back = a.seg_back[s] != 0;
    const int mode = a.seg_mode[s];
    const double scale = kPass == 2 ? seg_scale(a, s) : 1.0;
    float ws = 0.f, emax = 0.f, amax = 0.f;
    for (int c0 = 0; c0 < dd; c0 += kT) {
      const int w = wd.tile(c0);
      if constexpr (D == 0) load_tile(wd, c0, w, yq_row, yq);
      float agg[kT];
#pragma unroll
      for (int c = 0; c < kT; ++c) agg[c] = 0.f;
      for (int i = lane; i < a.seg_size[s]; i += 32) {
        const int64_t j = r * a.k + a.seg_start[s] + i;
        const int64_t t = repro::clamp_row(a.nbr[j], a.n);
        float delta[kT];
        const float d2 = edge_delta(wd, c0, w, yq_row, yq, a.y + t * dd,
                                    delta);
        float sc;
        const float wt = edge_scalars(mode, alpha, d2, a.coef[j], sc);
#pragma unroll
        for (int c = 0; c < kT; ++c) {
          if (c >= w) break;
          const float e = edge_comp(mode, sc, delta[c]);
          agg[c] += e;
          if (kPass == 1) {
            emax = fmaxf(emax, fabsf(e));
            bad = bad || !isfinite(e);
          } else if (back) {
            atomicAdd(a.acc + (s * a.n + t) * dd + c0 + c,
                      to_fixed(-e, scale));
          }
        }
        if (c0 == 0) {
          ws += wt;
          if (kPass == 1) bad = bad || !isfinite(wt);
        }
      }
#pragma unroll
      for (int c = 0; c < kT; ++c) agg[c] = warp_sum(agg[c]);
      if (kPass == 1) {
#pragma unroll
        for (int c = 0; c < kT; ++c) {
          if (c >= w) break;
          amax = fmaxf(amax, fabsf(agg[c]));
          bad = bad || !isfinite(agg[c]);
        }
      } else if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kT; ++c) {
          if (c >= w) break;
          atomicAdd(a.acc + (s * a.n + q) * dd + c0 + c,
                    to_fixed(agg[c], scale));
        }
      }
    }
    if (kPass == 1) {
      ws = warp_sum(ws);
      float m = fmaxf(back ? emax : 0.f, amax);
      m = warp_max(m);
      if (lane == 0) {
        a.wsum[s * a.b + r] = ws;
        atomicMax(a.max_bits + s, __float_as_uint(m));
      }
    }
  }
  if (kPass == 1 && __any_sync(repro::kFullMask, bad) && lane == 0)
    atomicOr(a.nonfinite, 1);
}

__global__ void forces_unpack_kernel(const ForceArgs a, int d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n_seg * a.n * d) return;
  if (*a.nonfinite) {
    a.out[i] = NAN;
    return;
  }
  const int s = static_cast<int>(i / (a.n * d));
  a.out[i] = static_cast<float>(
      static_cast<double>(static_cast<long long>(a.acc[i])) / seg_scale(a, s));
}

template <int D>
int launch(const ForceArgs& a, int d, cudaStream_t stream) {
  const Width<D> wd{d};
  if (a.b > 0) {
    const unsigned rows = static_cast<unsigned>((a.b + kWarps - 1) / kWarps);
    forces_rows_kernel<D, 1><<<rows, kWarps * 32, 0, stream>>>(a, wd);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    forces_rows_kernel<D, 2><<<rows, kWarps * 32, 0, stream>>>(a, wd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total = a.n_seg * a.n * d;
  if (total > 0) {
    forces_unpack_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                           stream>>>(a, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kGathered>
__global__ void __launch_bounds__(kWarps * 32)
    forces_edges_kernel(const EdgeArgs a, const Width<D> wd) {
  constexpr int kT = Width<D>::kT;
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= a.b) return;  // uniform per warp
  const float alpha = *a.alpha;
  const int dd = wd.cols();
  const float* yq_row =
      kGathered ? a.x + repro::clamp_row(a.qid[r], a.n) * dd : a.y + r * dd;
  float yq[kT];
  if constexpr (D > 0) load_tile(wd, 0, D, yq_row, yq);
  for (int s = 0; s < a.n_seg; ++s) {
    const int size = a.seg_size[s];
    const int mode = a.seg_mode[s];
    float* edge_out = a.edge[s];
    float ws = 0.f;
    for (int c0 = 0; c0 < dd; c0 += kT) {
      const int w = wd.tile(c0);
      if constexpr (D == 0) load_tile(wd, c0, w, yq_row, yq);
      float agg[kT];
#pragma unroll
      for (int c = 0; c < kT; ++c) agg[c] = 0.f;
      for (int i = lane; i < size; i += 32) {
        const int64_t j = r * a.k + a.seg_start[s] + i;
        const float* yt = kGathered
                              ? a.x + repro::clamp_row(a.nbr_idx[j], a.n) * dd
                              : a.nbr + j * dd;
        float delta[kT];
        const float d2 = edge_delta(wd, c0, w, yq_row, yq, yt, delta);
        float sc;
        const float wt = edge_scalars(mode, alpha, d2, a.coef[j], sc);
        if (c0 == 0) ws += wt;
#pragma unroll
        for (int c = 0; c < kT; ++c) {
          if (c >= w) break;
          const float e = edge_comp(mode, sc, delta[c]);
          agg[c] += e;
          if (edge_out != nullptr) edge_out[(r * size + i) * dd + c0 + c] = e;
        }
      }
#pragma unroll
      for (int c = 0; c < kT; ++c) agg[c] = warp_sum(agg[c]);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kT; ++c) {
          if (c >= w) break;
          a.agg[(s * a.b + r) * dd + c0 + c] = agg[c];
        }
      }
    }
    ws = warp_sum(ws);
    if (lane == 0) a.wsum[s * a.b + r] = ws;
  }
}

template <int D>
int launch_edges(const EdgeArgs& a, int d, cudaStream_t stream) {
  const Width<D> wd{d};
  if (a.b > 0) {
    const unsigned rows = static_cast<unsigned>((a.b + kWarps - 1) / kWarps);
    if (a.x != nullptr) {
      forces_edges_kernel<D, true><<<rows, kWarps * 32, 0, stream>>>(a, wd);
    } else {
      forces_edges_kernel<D, false><<<rows, kWarps * 32, 0, stream>>>(a, wd);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ne_forces_edges(const EdgeArgs* args, int d,
                                     cudaStream_t stream) {
  if (args->n_seg < 1 || args->n_seg > kMaxSeg || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 1: return launch_edges<1>(*args, d, stream);
    case 2: return launch_edges<2>(*args, d, stream);
    case 3: return launch_edges<3>(*args, d, stream);
    case 4: return launch_edges<4>(*args, d, stream);
    case 8: return launch_edges<8>(*args, d, stream);
    case 16: return launch_edges<16>(*args, d, stream);
    case 32: return launch_edges<32>(*args, d, stream);
    default: return launch_edges<0>(*args, d, stream);
  }
}

extern "C" int repro_ne_forces_scatter(const ForceArgs* args, int d,
                                       cudaStream_t stream) {
  if (args->n_seg < 1 || args->n_seg > kMaxSeg || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 1: return launch<1>(*args, d, stream);
    case 2: return launch<2>(*args, d, stream);
    case 3: return launch<3>(*args, d, stream);
    case 4: return launch<4>(*args, d, stream);
    case 8: return launch<8>(*args, d, stream);
    case 16: return launch<16>(*args, d, stream);
    case 32: return launch<32>(*args, d, stream);
    default: return launch<0>(*args, d, stream);
  }
}
