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
// The scale of segment s is 2^(62 - e), where 2^e exceeds its largest
// |term| times its number of terms, so no row total can overflow; values
// within 2^-17 of the largest keep float32 precision.  A non-finite term
// sets a flag that turns the whole output into NaN.
//
// What holds it back on the card: the scale needs every term before any
// is summed, so each edge is gathered twice, and the reactions are 6.7 M
// int64 atomics at the main path's shape.  A per-row atomicMax on three
// words, or atomics from one thread per edge and column, cost as much as
// the rest of the work (profiler, NVIDIA H100 80GB HBM3, 700 W).
//
// Design, three kernels.  Pass 1 (forces_terms_kernel) computes every
// edge once.  Its blocks are resident and stride over the rows; a warp
// takes a row's rounds in turn, where a round is one segment on the whole
// warp (lane i holds edges i, i + 32, ...) or two segments of at most 16
// edges on the two half-warps, so the main path's row is two rounds (HD;
// LD beside the negatives) and no lane idles.  A round's sums are the
// butterfly of the whole warp, or of the half-warp (offsets 8 .. 1):
// lanes past a 16-edge segment held exact zeros there, so both give the
// same bits.  Pass 1 writes the wsums and each row's float aggregates, and
// keeps each segment's largest |term| per block in shared memory (one
// atomicMax a block and segment).  It also zeroes the accumulators.  Pass
// 2 (forces_scatter_kernel) recomputes the edges of the segments that
// scatter back (the same arithmetic, so the same bits) and adds each
// reaction with 64-bit integer atomics in L2: up to d = 8 one lane a
// column, so that a warp's atomics fall on whole rows; past that one
// thread an edge, since each lane recomputes the whole row.  Pass 3
// (forces_unpack_kernel) adds each row's quantised aggregate to its own
// row's sum and converts back to float32; where qid is not the identity
// (pass 1 flags it), pass 2 adds the aggregates with atomics instead.
// Integer sums do not depend on order, so the output is bit for bit that
// of the single-pass atomics design.  The launch adds one memset (the
// per-segment maxima and two flags); the wrapper two allocations.
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
#include <algorithm>

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
  float* agg;                  // (S, B, D) each row's aggregate, scratch
  unsigned int* max_bits;      // (S + 2,) bits of each segment's largest
                               // |term|, then the non-finite flag and the
                               // flag "qid is not the identity"; zeroed by
                               // the launch
  unsigned long long* acc;     // (S, N, D) fixed point, zeroed by pass 1
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

// The rounds of a row (pass 1) and the segments that scatter back (pass 2),
// planned on the host from the segment sizes.  Round t is segment lo[t] on
// the whole warp, or with half[t] segment lo[t] on lanes 0-15 and hi[t]
// (-1: none) on lanes 16-31; consecutive segments of at most 16 edges share
// a round.
struct Plan {
  int n_round;
  int lo[kMaxSeg];
  int hi[kMaxSeg];
  int half[kMaxSeg];
  int n_back;
  int back[kMaxSeg];           // the segments that scatter back, in order
  int back_first[kMaxSeg];     // each one's first edge among them
  int k_back;                  // their edges per row
};

Plan make_plan(const ForceArgs& a) {
  Plan p{};
  for (int s = 0; s < a.n_seg; ++s) {
    const int t = p.n_round;
    if (t > 0 && p.half[t - 1] && p.hi[t - 1] < 0 && a.seg_size[s] <= 16) {
      p.hi[t - 1] = s;
    } else {
      p.lo[t] = s;
      p.hi[t] = -1;
      p.half[t] = a.seg_size[s] <= 16;
      ++p.n_round;
    }
    if (a.seg_back[s]) {
      p.back[p.n_back] = s;
      p.back_first[p.n_back++] = p.k_back;
      p.k_back += a.seg_size[s];
    }
  }
  return p;
}

// Sum over the warp (offsets 16 .. 1) or over each half-warp (8 .. 1).
__device__ __forceinline__ float round_sum(float v, bool half) {
  for (int off = half ? 8 : 16; off; off >>= 1)
    v += __shfl_xor_sync(repro::kFullMask, v, off);
  return v;
}

// Pass 1: each edge's terms once; per (row, segment) the wsum and the
// float aggregate; each segment's largest |term| (over the back edges and
// the aggregates); the non-finite and not-identity flags; acc zeroed.  The
// blocks are resident and stride over the rows; a warp takes a row's rounds
// in turn.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    forces_terms_kernel(const ForceArgs a, const Plan p, const Width<D> wd) {
  constexpr int kT = Width<D>::kT;
  __shared__ Plan sp;
  __shared__ unsigned s_max[kWarps][kMaxSeg];
  __shared__ unsigned s_flags;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    sp = p;
    s_flags = 0u;
  }
  if (lane < kMaxSeg) s_max[w][lane] = 0u;
  const int dd = wd.cols();
  const int64_t n_acc = a.n_seg * a.n * dd;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_acc; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    a.acc[i] = 0ull;
  __syncthreads();

  const float alpha = *a.alpha;
  bool bad = false, permuted = false;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + w; r < a.b;
       r += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t q = repro::clamp_row(a.qid[r], a.n);
    permuted = permuted || q != r;
    const float* yq_row = a.y + q * dd;
    float yq[kT];
    if constexpr (D > 0) load_tile(wd, 0, D, yq_row, yq);
    for (int t = 0; t < sp.n_round; ++t) {
      const bool half = sp.half[t] != 0;
      const int s = half && lane >= 16 ? sp.hi[t] : sp.lo[t];
      const int li = half ? lane & 15 : lane;
      const int size = s >= 0 ? a.seg_size[s] : 0;
      const int mode = s >= 0 ? a.seg_mode[s] : 0;
      const bool back = s >= 0 && a.seg_back[s] != 0;
      float ws = 0.f, emax = 0.f, amax = 0.f;
      for (int c0 = 0; c0 < dd; c0 += kT) {
        const int wc = wd.tile(c0);
        if constexpr (D == 0) load_tile(wd, c0, wc, yq_row, yq);
        float agg[kT];
#pragma unroll
        for (int c = 0; c < kT; ++c) agg[c] = 0.f;
        for (int i = li; i < size; i += half ? 16 : 32) {
          const int64_t j = r * a.k + a.seg_start[s] + i;
          const int64_t tr = repro::clamp_row(a.nbr[j], a.n);
          float delta[kT];
          const float d2 = edge_delta(wd, c0, wc, yq_row, yq, a.y + tr * dd,
                                      delta);
          float sc;
          const float wt = edge_scalars(mode, alpha, d2, a.coef[j], sc);
#pragma unroll
          for (int c = 0; c < kT; ++c) {
            if (c >= wc) break;
            const float e = edge_comp(mode, sc, delta[c]);
            agg[c] += e;
            emax = fmaxf(emax, fabsf(e));
            bad = bad || !isfinite(e);
          }
          if (c0 == 0) {
            ws += wt;
            bad = bad || !isfinite(wt);
          }
        }
#pragma unroll
        for (int c = 0; c < kT; ++c) agg[c] = round_sum(agg[c], half);
#pragma unroll
        for (int c = 0; c < kT; ++c) {
          if (c >= wc) break;
          amax = fmaxf(amax, fabsf(agg[c]));
          bad = bad || !isfinite(agg[c]);
          if (li == 0 && s >= 0) a.agg[(s * a.b + r) * dd + c0 + c] = agg[c];
        }
      }
      ws = round_sum(ws, half);
      if (li == 0 && s >= 0) a.wsum[s * a.b + r] = ws;
      // |terms| are >= 0 (fmaxf drops NaN), so their bits order as unsigned
      const unsigned bits = __float_as_uint(fmaxf(back ? emax : 0.f, amax));
      const unsigned m_lo =
          __reduce_max_sync(repro::kFullMask, half && lane >= 16 ? 0u : bits);
      const unsigned m_hi =
          __reduce_max_sync(repro::kFullMask, half && lane >= 16 ? bits : 0u);
      if (lane == 0) {
        const int lo = sp.lo[t], hi = sp.hi[t];
        s_max[w][lo] = max(s_max[w][lo], m_lo);
        if (half && hi >= 0) s_max[w][hi] = max(s_max[w][hi], m_hi);
      }
    }
  }
  const unsigned flags = (__any_sync(repro::kFullMask, bad) ? 1u : 0u) |
                         (__any_sync(repro::kFullMask, permuted) ? 2u : 0u);
  if (lane == 0 && flags) atomicOr(&s_flags, flags);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < a.n_seg) {
    unsigned m = 0u;
    for (int v = 0; v < kWarps; ++v) m = max(m, s_max[v][threadIdx.x]);
    if (m) atomicMax(a.max_bits + threadIdx.x, m);
  }
  if (threadIdx.x == 0) {
    if (s_flags & 1u) atomicOr(a.max_bits + a.n_seg, 1u);
    if (s_flags & 2u) atomicOr(a.max_bits + a.n_seg + 1, 1u);
  }
}

// Pass 2: the reaction -edge of every edge of a segment that scatters back,
// added to the neighbour's row with 64-bit integer atomics; kG lanes take
// one edge, lane c its column c (kG = 1: one thread an edge, every
// column), so a warp's atomics fall on whole rows.  Where qid is not the
// identity, the threads past those edges add each (row, segment)
// aggregate to its row.
template <int D, int kG>
__global__ void __launch_bounds__(256)
    forces_scatter_kernel(const ForceArgs a, const Plan p, const Width<D> wd) {
  constexpr int kT = Width<D>::kT;
  __shared__ double s_scale[kMaxSeg];
  if (static_cast<int>(threadIdx.x) < a.n_seg)
    s_scale[threadIdx.x] = seg_scale(a, threadIdx.x);
  __syncthreads();
  if (a.max_bits[a.n_seg]) return;  // non-finite: the output is NaN
  const int64_t it = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int dd = wd.cols();
  const int64_t n_edge = a.b * p.k_back;
  if (it >= n_edge * kG) {
    const int64_t ia = it - n_edge * kG;
    if (ia >= a.b * a.n_seg || !a.max_bits[a.n_seg + 1]) return;
    const int s = static_cast<int>(ia / a.b);
    const int64_t r = ia - s * a.b;
    const int64_t q = repro::clamp_row(a.qid[r], a.n);
    for (int c = 0; c < dd; ++c)
      atomicAdd(a.acc + (s * a.n + q) * dd + c,
                to_fixed(a.agg[(s * a.b + r) * dd + c], s_scale[s]));
    return;
  }
  const int64_t e = it / kG;
  const int cl = static_cast<int>(it - e * kG);
  const int64_t r = e / p.k_back;
  int i = static_cast<int>(e - r * p.k_back), s = p.back[0], i0 = 0;
#pragma unroll
  for (int v = 1; v < kMaxSeg; ++v) {
    if (v < p.n_back && i >= p.back_first[v]) {
      s = p.back[v];
      i0 = p.back_first[v];
    }
  }
  i -= i0;
  const float alpha = *a.alpha;
  const int mode = a.seg_mode[s];
  const double scale = s_scale[s];
  const int64_t q = repro::clamp_row(a.qid[r], a.n);
  const int64_t j = r * a.k + a.seg_start[s] + i;
  const int64_t tr = repro::clamp_row(a.nbr[j], a.n);
  const float cf = a.coef[j];
  const float* yq_row = a.y + q * dd;
  unsigned long long* out = a.acc + (s * a.n + tr) * dd;
  float yq[kT];
  for (int c0 = 0; c0 < dd; c0 += kT) {  // one tile when D > 0
    const int wc = wd.tile(c0);
    load_tile(wd, c0, wc, yq_row, yq);
    float delta[kT];
    const float d2 = edge_delta(wd, c0, wc, yq_row, yq, a.y + tr * dd, delta);
    float sc;
    edge_scalars(mode, alpha, d2, cf, sc);
    if constexpr (kG == 1) {
#pragma unroll
      for (int c = 0; c < kT; ++c) {
        if (c >= wc) break;
        atomicAdd(out + c0 + c,
                  to_fixed(-edge_comp(mode, sc, delta[c]), scale));
      }
    } else {
      float dc = 0.f;
#pragma unroll
      for (int c = 0; c < kT; ++c) dc = c == cl ? delta[c] : dc;
      if (cl < wc) atomicAdd(out + cl, to_fixed(-edge_comp(mode, sc, dc), scale));
    }
  }
}

// Pass 3: back to float32; each row's own aggregate joins its integer sum
// here when qid is the identity (pass 2 added it otherwise).
__global__ void forces_unpack_kernel(const ForceArgs a, int d) {
  __shared__ double s_scale[kMaxSeg];
  if (static_cast<int>(threadIdx.x) < a.n_seg)
    s_scale[threadIdx.x] = seg_scale(a, threadIdx.x);
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n_seg * a.n * d) return;
  if (a.max_bits[a.n_seg]) {
    a.out[i] = NAN;
    return;
  }
  const int s = static_cast<int>(i / (a.n * d));
  const int64_t row = (i - s * a.n * d) / d;
  const double scale = s_scale[s];
  unsigned long long v = a.acc[i];
  if (row < a.b && !a.max_bits[a.n_seg + 1])
    v += to_fixed(a.agg[(s * a.b + row) * d + (i - (s * a.n + row) * d)],
                  scale);
  a.out[i] = static_cast<float>(
      static_cast<double>(static_cast<long long>(v)) / scale);
}

// Blocks of `kernel` that fill the card once (at most `want`).
template <typename Kernel>
unsigned resident_blocks(Kernel kernel, int threads, int64_t want) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int64_t full = std::max<int64_t>(1, static_cast<int64_t>(sms) * per_sm);
  return static_cast<unsigned>(std::max<int64_t>(1, std::min(want, full)));
}

// Lanes per edge in pass 2: one a column up to 8 columns (a power of two
// >= D); past that one thread an edge, since every lane of an edge
// recomputes the whole row's |delta|^2.
constexpr int cols_lanes(int d) {
  return d <= 1 ? 1 : d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : 1;
}

template <int D>
int launch(const ForceArgs& a, int d, cudaStream_t stream) {
  constexpr int kG = D > 0 ? cols_lanes(D) : 1;
  const Width<D> wd{d};
  const Plan p = make_plan(a);
  cudaError_t err = cudaMemsetAsync(a.max_bits, 0,
                                    sizeof(unsigned) * (a.n_seg + 2), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = a.n_seg * a.n * d;
  const unsigned grid1 = resident_blocks(
      forces_terms_kernel<D>, kWarps * 32,
      std::max<int64_t>((a.b + kWarps - 1) / kWarps,
                        (total + kWarps * 32 - 1) / (kWarps * 32)));
  forces_terms_kernel<D><<<grid1, kWarps * 32, 0, stream>>>(a, p, wd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t threads = a.b * (p.k_back * kG + a.n_seg);
  if (threads > 0) {
    forces_scatter_kernel<D, kG>
        <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
            a, p, wd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
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

