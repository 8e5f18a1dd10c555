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
// B5 and B7: edge-emitting forces, three routes, each a kernel template in
// two input modes.
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
// Design: three routes by the width d (edges_route in ops.py), each with
// its own C entry; every edge is the same arithmetic (edge_delta,
// edge_scalars, edge_comp) and every sum the same tree, so all three give
// the same bits.
//  * rounds (d <= 4, repro_ne_forces_edges_rounds): B3's round plan, so
//    the flag paths' 16-edge segments share a warp (B5's row is two
//    rounds; B7 at K 16 two rows a warp); each lane loads its ids,
//    coefficients and rows for all rounds before any arithmetic and
//    stores its edge as one vector at d = 2 and 4;
//  * staged (d = 8 and 32 with rows on 16 bytes,
//    repro_ne_forces_edges_staged): the same rounds, with each chunk of 32
//    neighbour rows copied into shared memory and each chunk of edges
//    stored from there, both coalesced;
//  * warp (every other row, repro_ne_forces_edges): one warp per row, lane
//    k takes edges k, k + 32, ... and reads and writes them column by
//    column.
// The TPU kernel's SMEM index slabs and double-buffered row DMAs have no
// counterpart: the gathered rows are served by L2, where the (N, d)
// embedding stays.
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

// A float of a row: through the read-only path from global memory (kLdg),
// or a plain load (a row staged in shared memory or held in registers).
template <bool kLdg>
__device__ __forceinline__ float row_ld(const float* __restrict__ p) {
  if constexpr (kLdg) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// |delta|^2 of one edge and the tile [c0, c0 + w) of delta.  With D > 0
// the tile is the whole row and yq holds it; with D = 0 the row sum reads
// both rows (L1/L2-resident) and yq holds the tile only.
template <int D, bool kLdg = true>
__device__ __forceinline__ float edge_delta(const Width<D>& wd, int c0, int w,
                                            const float* __restrict__ yq_row,
                                            const float (&yq)[Width<D>::kT],
                                            const float* __restrict__ yt,
                                            float (&delta)[Width<D>::kT]) {
  float d2 = 0.f;
  if constexpr (D > 0) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      delta[c] = row_ld<kLdg>(yt + c) - yq[c];
      d2 += delta[c] * delta[c];
    }
  } else {
    for (int c = 0; c < wd.d; ++c) {
      const float dl = row_ld<kLdg>(yt + c) - row_ld<kLdg>(yq_row + c);
      d2 += dl * dl;
    }
#pragma unroll
    for (int c = 0; c < kTile; ++c)
      delta[c] = c < w ? row_ld<kLdg>(yt + c0 + c) - yq[c] : 0.f;
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

// The rounds of a row over segments of size[0 .. n_seg) edges, and the
// segments that scatter back (back: per segment, null: none), planned on
// the host for B3 (pass 1's rounds, pass 2's back segments) and for the
// rounds and staged routes of B5 and B7.  Round t is segment lo[t] on the
// whole warp, or with half[t] segment lo[t] on lanes 0-15 and hi[t] (-1:
// none) on lanes 16-31; consecutive segments of at most 16 edges share a
// round.
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

Plan make_plan(int n_seg, const int* size, const int* back) {
  Plan p{};
  for (int s = 0; s < n_seg; ++s) {
    const int t = p.n_round;
    if (t > 0 && p.half[t - 1] && p.hi[t - 1] < 0 && size[s] <= 16) {
      p.hi[t - 1] = s;
    } else {
      p.lo[t] = s;
      p.hi[t] = -1;
      p.half[t] = size[s] <= 16;
      ++p.n_round;
    }
    if (back != nullptr && back[s]) {
      p.back[p.n_back] = s;
      p.back_first[p.n_back++] = p.k_back;
      p.k_back += size[s];
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
  const Plan p = make_plan(a.n_seg, a.seg_size, a.seg_back);
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

// ---- B5 and B7, rounds and staged routes ---------------------------------

constexpr int kRoundsMaxD = 4;       // the rounds route's widest row
constexpr int kStagedWarps = 4;      // the staged route's block

// Row stride of the staged route's tiles: odd, so that lane i's reads of
// row i (one column at a time) fall in 32 different banks.
__host__ __device__ constexpr int staged_ld(int d) { return d | 1; }

// The rounds of a row as the kernels read them, made by the launcher from
// the plan of the segment sizes (make_rounds): round t, half h (h = 1:
// lanes 16-31 of a round on the half-warps, or in pair mode the warp's
// second row; a round on the whole warp repeats its segment in both) has
// segment seg (-1: none), its first edge in the row's K (start), its edges
// (size), mode and edge output (null: not emitted).  pair: two rows a
// warp, one on each half-warp (the plan is one round of one segment of at
// most 16 edges, B7 at K 16).  The kernels index it by a compile-time
// round (their round loops are unrolled), so each entry is an operand in
// constant memory and a row's setup is a few selects.
struct Rounds {
  int n;
  int pair;
  int half[kMaxSeg];
  int seg[kMaxSeg][2];
  int start[kMaxSeg][2];
  int size[kMaxSeg][2];
  int mode[kMaxSeg][2];
  float* edge[kMaxSeg][2];
};

Rounds make_rounds(const EdgeArgs& a) {
  const Plan p = make_plan(a.n_seg, a.seg_size, nullptr);
  Rounds rt{};
  rt.n = p.n_round;
  rt.pair = p.n_round == 1 && p.half[0] && p.hi[0] < 0;
  for (int t = 0; t < rt.n; ++t) {
    rt.half[t] = p.half[t];
    for (int h = 0; h < 2; ++h) {
      const int s = h && p.half[t] && !rt.pair ? p.hi[t] : p.lo[t];
      rt.seg[t][h] = s;
      if (s >= 0) {
        rt.start[t][h] = a.seg_start[s];
        rt.size[t][h] = a.seg_size[s];
        rt.mode[t][h] = a.seg_mode[s];
        rt.edge[t][h] = a.edge[s];
      }
    }
  }
  return rt;
}

// One half of round t of a warp's row (h: see Rounds), at row r0 + (pair
// and h): its segment (-1: none, or its row past B), row, edges, first id
// slot (in = r * k + start), mode and edge output.
struct Half {
  int s;
  int64_t r;
  int size;
  int64_t in;
  int mode;
  float* edge;
};

__device__ __forceinline__ Half round_half(const EdgeArgs& a, const Rounds& rt,
                                           int t, bool h, bool pair,
                                           int64_t r0) {
  Half x;
  x.r = r0 + (pair && h ? 1 : 0);
  x.s = h ? rt.seg[t][1] : rt.seg[t][0];
  if (x.r >= a.b) x.s = -1;
  const bool live = x.s >= 0;
  x.size = live ? (h ? rt.size[t][1] : rt.size[t][0]) : 0;
  x.in = x.r * a.k + (h ? rt.start[t][1] : rt.start[t][0]);
  x.mode = h ? rt.mode[t][1] : rt.mode[t][0];
  x.edge = live ? (h ? rt.edge[t][1] : rt.edge[t][0]) : nullptr;
  return x;
}

// One level of the butterfly of round_sum on D columns held by a lane, at
// lane offset kOff, with half of the lane's kW columns exchanged while it
// holds more than one, then the levels below (see reduce_cols).
template <int D, int kW, int kOff>
__device__ __forceinline__ void reduce_level(float (&v)[D], int lane, int& c0) {
  if constexpr (kOff > 0) {
    if constexpr (kW > 1) {
      const bool up = (lane & kOff) != 0;
#pragma unroll
      for (int c = 0; c < kW / 2; ++c) {
        const float send = up ? v[c] : v[c + kW / 2];
        const float keep = up ? v[c + kW / 2] : v[c];
        v[c] = keep + __shfl_xor_sync(repro::kFullMask, send, kOff);
      }
      if (up) c0 += kW / 2;
      reduce_level<D, kW / 2, kOff / 2>(v, lane, c0);
    } else {
      v[0] += __shfl_xor_sync(repro::kFullMask, v[0], kOff);
      reduce_level<D, 1, kOff / 2>(v, lane, c0);
    }
  }
}

// The sums over N lanes (32, or 16 on each half-warp) of the D columns v,
// the butterfly of round_sum on each column (the same pairs at every
// level, so the same bits) with half of the lane's columns exchanged at
// each level while it holds more than one (a reduce-scatter: D / 2 + D / 4
// + ... shuffles instead of D log N).  Lane l ends with the sums of columns
// [c0, c0 + max(1, D / N)) in v[0 ..], c0 returned; lanes that differ only
// in their bits below N / D hold the same columns.  D is a power of two.
template <int D, int N>
__device__ __forceinline__ int reduce_cols(float (&v)[D], int lane) {
  static_assert((D & (D - 1)) == 0, "D must be a power of two");
  int c0 = 0;
  reduce_level<D, D, N / 2>(v, lane, c0);
  return c0;
}

// A round's aggregates of one lane's half: summed over the warp (half =
// false) or each half-warp, then written to agg_row (the segment's row of
// aggs, null: none).  Powers of two by reduce_cols, one store a column from
// a lane that holds it; other widths by round_sum per column, from the
// half's first lane.
template <int D>
__device__ __forceinline__ void store_aggs(float (&v)[D], bool half, int lane,
                                           float* agg_row) {
  if constexpr ((D & (D - 1)) == 0) {
    const int lh = lane & (half ? 15 : 31);
    if (half) {
      constexpr int kOwn = D >= 16 ? D / 16 : 1, kDup = D >= 16 ? 1 : 16 / D;
      const int c0 = reduce_cols<D, 16>(v, lane);
      if (lh % kDup == 0 && agg_row != nullptr) {
#pragma unroll
        for (int u = 0; u < kOwn; ++u) agg_row[c0 + u] = v[u];
      }
    } else {
      constexpr int kOwn = D >= 32 ? D / 32 : 1, kDup = D >= 32 ? 1 : 32 / D;
      const int c0 = reduce_cols<D, 32>(v, lane);
      if (lh % kDup == 0 && agg_row != nullptr) {
#pragma unroll
        for (int u = 0; u < kOwn; ++u) agg_row[c0 + u] = v[u];
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = round_sum(v[c], half);
    if ((lane & (half ? 15 : 31)) == 0 && agg_row != nullptr) {
#pragma unroll
      for (int c = 0; c < D; ++c) agg_row[c] = v[c];
    }
  }
}

// A row of D <= 4 floats into registers: one 8- or 16-byte load at D = 2
// and 4 where the row is aligned (vec), else one float at a time.
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ p, bool vec,
                                         float (&v)[D]) {
  if constexpr (D == 2) {
    if (vec) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = t.x;
      v[1] = t.y;
      return;
    }
  } else if constexpr (D == 4) {
    if (vec) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) v[c] = __ldg(p + c);
}

// A row of D <= 4 floats from registers: one 8- or 16-byte store at D = 2
// and 4 where the row is aligned (vec), else one float at a time.
template <int D>
__device__ __forceinline__ void store_row(float* p, bool vec,
                                          const float (&v)[D]) {
  if constexpr (D == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      return;
    }
  } else if constexpr (D == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) p[c] = v[c];
}

// Rounds route, d <= 4.  A warp takes kUnits units (rounds_units), a unit
// being one row (two in pair mode), and runs each unit's rounds (B3's plan): B5's row at
// (32, 16, 16) is two rounds, the attraction on the whole warp, then the
// two repulsions on the half-warps; B7 at K 16 puts two rows on a warp.
// Each lane first loads, for every unit, the query row and the id and
// coefficient of its first edge in the first kPreload rounds (B7: its one
// round), then those edges' rows, before any arithmetic, so one latency
// covers them all.  Each edge is the warp route's (edge_delta,
// edge_scalars, edge_comp), stored as one vector at d = 2 and 4; a round's
// sums are the butterfly of the warp or of the half-warp, which give the
// warp route's bits: a lane past a segment holds an exact +0, and no
// partial sum is -0.
constexpr int kPreload = 2;

// B5's rows have several rounds, B7's one: a B7 warp takes two units.
template <bool kGathered>
__host__ __device__ constexpr int rounds_units() {
  return kGathered ? 1 : 2;
}

// At least 6 blocks an SM at d <= 2, 5 above (d = 4 spills at 6): the
// route is bound by each warp's chain of loads, so resident warps count.
template <int D, bool kGathered>
__global__ void __launch_bounds__(kWarps * 32, D <= 2 ? 6 : 5)
    forces_rounds_kernel(const EdgeArgs a, const Rounds rt, const Width<D> wd,
                         const bool vec) {
  constexpr int kUnits = rounds_units<kGathered>();
  const int lane = threadIdx.x & 31;
  const bool pair = rt.pair != 0, upper = lane >= 16;
  const int64_t rows = pair ? 2 : 1;  // a unit's
  const int64_t r_first =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kUnits * rows;
  if (r_first >= a.b) return;  // uniform per warp
  const float alpha = *a.alpha;
  // B7 is one segment a launch: one round (or one pair of rows)
  constexpr int kRounds = kGathered ? kMaxSeg : 1;
  constexpr int kPre = kRounds < kPreload ? kRounds : kPreload;

  // each unit's query row; the first edge of this lane in the first kPre
  // rounds: its id and coefficient, then its row
  const float* yq_row[kUnits];
  float yq[kUnits][D], cf0[kUnits][kPre], row0[kUnits][kPre][D];
  int64_t t0[kUnits][kPre];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int64_t r0 = r_first + u * rows;
    const int64_t rl = r0 + (pair && upper ? 1 : 0);
    const int64_t rq = rl < a.b ? rl : a.b - 1;  // a dead row: the last one
    yq_row[u] = kGathered ? a.x + repro::clamp_row(a.qid[rq], a.n) * D
                          : a.y + rq * D;
    load_tile(wd, 0, D, yq_row[u], yq[u]);
#pragma unroll
    for (int t = 0; t < kPre; ++t) {
      const Half h = round_half(a, rt, t, rt.half[t] && upper, pair, r0);
      const int li = rt.half[t] ? lane & 15 : lane;
      const bool has = t < rt.n && li < h.size;
      cf0[u][t] = has ? a.coef[h.in + li] : 0.f;
      t0[u][t] = !has       ? -1
                 : kGathered ? repro::clamp_row(a.nbr_idx[h.in + li], a.n)
                             : h.in + li;
    }
  }
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
#pragma unroll
    for (int t = 0; t < kPre; ++t) {
      if (t0[u][t] >= 0) {
        load_row<D>((kGathered ? a.x : a.nbr) + t0[u][t] * D, vec, row0[u][t]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int64_t r0 = r_first + u * rows;
    if (r0 >= a.b) break;  // uniform
#pragma unroll
    for (int t = 0; t < kRounds; ++t) {
      if (t >= rt.n) break;  // uniform
      const bool half = rt.half[t] != 0;
      const Half h = round_half(a, rt, t, half && upper, pair, r0);
      float* edge_out = h.edge;
      const int li = half ? lane & 15 : lane;
      float agg[D];
#pragma unroll
      for (int c = 0; c < D; ++c) agg[c] = 0.f;
      float ws = 0.f;
      for (int i = li; i < h.size; i += half ? 16 : 32) {
        const bool first = t < kPre && i == li;
        const int64_t j = h.in + i;
        float yt[D], cf;
        if (first) {
          cf = cf0[u][t < kPre ? t : 0];
#pragma unroll
          for (int c = 0; c < D; ++c) yt[c] = row0[u][t < kPre ? t : 0][c];
        } else {
          cf = a.coef[j];
          load_row<D>(kGathered
                          ? a.x + repro::clamp_row(a.nbr_idx[j], a.n) * D
                          : a.nbr + j * D,
                      vec, yt);
        }
        float delta[D];
        const float d2 =
            edge_delta<D, false>(wd, 0, D, yq_row[u], yq[u], yt, delta);
        float sc;
        ws += edge_scalars(h.mode, alpha, d2, cf, sc);
        float e[D];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          e[c] = edge_comp(h.mode, sc, delta[c]);
          agg[c] += e[c];
        }
        if (edge_out != nullptr) {
          store_row<D>(edge_out + (h.r * h.size + i) * D, vec, e);
        }
      }
      store_aggs<D>(agg, half, lane,
                    h.s >= 0 ? a.agg + (h.s * a.b + h.r) * D : nullptr);
      ws = round_sum(ws, half);
      if ((lane & (half ? 15 : 31)) == 0 && h.s >= 0) {
        a.wsum[h.s * a.b + h.r] = ws;
      }
    }
  }
}

// The staged route's copies between a warp's tile (row stride staged_ld(D))
// and global memory, rows of D floats on 16 bytes: load f of a row of kNv
// float4s goes to lane f % kNv, so a warp's pass covers 32 / kNv whole rows
// (slots), and the passes over a round on the half-warps split at slot 16.
// row_at(q) gives slot q's row in global memory (null: none; its tile row
// gets zeros, which no lane reads).  All of a lane's loads are issued
// before its first store to the tile, so the warp waits for one latency,
// not one a pass.
template <int D, class RowAt>
__device__ __forceinline__ void tile_load(float* T, int lane, RowAt row_at) {
  constexpr int kNv = D / 4, kRows = 32 / kNv;
  const int c4 = lane % kNv;
  float4 v[kNv];
#pragma unroll
  for (int it = 0; it < kNv; ++it) {
    const float* src = row_at(it * kRows + lane / kNv);
    v[it] = src != nullptr
                ? __ldg(reinterpret_cast<const float4*>(src) + c4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int it = 0; it < kNv; ++it) {
    float* t = T + (it * kRows + lane / kNv) * staged_ld(D) + 4 * c4;
    t[0] = v[it].x;
    t[1] = v[it].y;
    t[2] = v[it].z;
    t[3] = v[it].w;
  }
}

template <int D, class RowAt>
__device__ __forceinline__ void tile_store(const float* T, int lane,
                                           RowAt row_at) {
  constexpr int kNv = D / 4, kRows = 32 / kNv;
  const int c4 = lane % kNv;
#pragma unroll
  for (int it = 0; it < kNv; ++it) {
    const int q = it * kRows + lane / kNv;
    float* dst = row_at(q);
    if (dst != nullptr) {
      const float* t = T + q * staged_ld(D) + 4 * c4;
      reinterpret_cast<float4*>(dst)[c4] = make_float4(t[0], t[1], t[2], t[3]);
    }
  }
}

// Staged route, d = 8 and 32 (the widths the flag paths run past the rounds
// route's), rows on 16 bytes.  A warp takes one row (two in pair mode) and
// runs its rounds as the rounds route does, 32 edge slots at a time (slot q
// on lane q; a round on the half-warps: slots 0-15 and 16-31): the warp
// copies its slots' neighbour rows (B7: each half's contiguous rows; B5:
// each row at its clipped id) into a tile in shared memory with 16-byte
// loads coalesced over the rows; lane i computes edge i from row i of the
// tile exactly as the warp route (edge_delta, edge_scalars, edge_comp) and
// writes it back into row i; the warp stores the tile coalesced.  Each
// lane's partial aggregates stay in registers, reduced by reduce_cols.  The
// warp route read each row and wrote each edge one column at a time, a
// lane per row: 32 rows, 32 sectors, for 4 bytes each.
template <int D, bool kGathered>
__global__ void __launch_bounds__(kStagedWarps * 32)
    forces_staged_kernel(const EdgeArgs a, const Rounds rt) {
  static_assert(D % 4 == 0 && 32 % (D / 4) == 0, "rows of whole float4s");
  constexpr int kLd = staged_ld(D);
  // B7 is one segment a launch: one round (or one pair of rows)
  constexpr int kRounds = kGathered ? kMaxSeg : 1;
  // a warp's tile of 32 neighbour rows (then their edges) and 2 query rows
  __shared__ float smem[kStagedWarps][34 * kLd];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* T = smem[w];
  float* Q = T + 32 * kLd;
  const bool pair = rt.pair != 0, upper = lane >= 16;
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kStagedWarps + w;
  const int64_t r0 = pair ? 2 * unit : unit;
  if (r0 >= a.b) return;  // uniform per warp
  const float alpha = *a.alpha;
  const Width<D> wd{D};
  // the warp's query rows, loaded here and stored into Q beside the first
  // chunk's rows, so the two loads overlap
  constexpr int kQv = (2 * D + 31) / 32;
  float qv[kQv];
#pragma unroll
  for (int u = 0; u < kQv; ++u) {
    const int f = lane + 32 * u, h = f >= D ? 1 : 0, c = f - h * D;
    const int64_t r = r0 + h < a.b ? r0 + h : a.b - 1;
    qv[u] = f >= (pair ? 2 : 1) * D ? 0.f
            : kGathered             ? a.x[repro::clamp_row(a.qid[r], a.n) * D + c]
                                    : a.y[r * D + c];
  }
  bool q_due = true;  // qv not yet in Q
  const float* q_row = Q + (pair && upper ? kLd : 0);
  // the query row: in registers, or at D = 32 read from the tile's query
  // row in shared memory (32 registers fewer, a broadcast read each)
  constexpr bool kQueryShared = D >= 32;
  float yq_regs[D];
  const float(&yq)[D] = *reinterpret_cast<const float(*)[D]>(
      kQueryShared ? q_row : yq_regs);
  float* t_row = T + lane * kLd;
  const float* src = kGathered ? a.x : a.nbr;

#pragma unroll
  for (int t = 0; t < kRounds; ++t) {
    if (t >= rt.n) break;  // uniform
    const bool half = rt.half[t] != 0;
    const Half h0 = round_half(a, rt, t, false, pair, r0);
    const Half h1 = half ? round_half(a, rt, t, true, pair, r0) : h0;
    const bool mine1 = half && upper;
    const int li = half ? lane & 15 : lane;
    const int size = mine1 ? h1.size : h0.size, mode = mine1 ? h1.mode : h0.mode;
    float* const eo0 = h0.edge == nullptr ? nullptr : h0.edge + h0.r * h0.size * D;
    float* const eo1 = h1.edge == nullptr ? nullptr : h1.edge + h1.r * h1.size * D;
    const int n_max = max(h0.size, h1.size);
    // this lane's segment row of aggs (null: no segment)
    float* const agg_row =
        (mine1 ? h1.s : h0.s) >= 0
            ? a.agg + ((mine1 ? h1.s : h0.s) * a.b + (mine1 ? h1.r : h0.r)) * D
            : nullptr;
    float agg[D];
#pragma unroll
    for (int c = 0; c < D; ++c) agg[c] = 0.f;
    float ws = 0.f;
    for (int i0 = 0; i0 < n_max; i0 += half ? 16 : 32) {  // uniform
      const int i = i0 + li;
      const bool has = i < size;
      const int64_t j = (mine1 ? h1.in : h0.in) + i;
      const float cf = has ? a.coef[j] : 0.f;
      int idx = 0;
      if constexpr (kGathered) {
        idx = has ? static_cast<int>(repro::clamp_row(a.nbr_idx[j], a.n)) : 0;
      }
      // slot q: its half (q1), its edge (iq), and its row's place in
      // global memory; captured by value, so nothing goes to the stack
      const int size0 = h0.size, size1 = h1.size;
      const int64_t in0 = h0.in, in1 = h1.in;
      const auto row_in = [=](int q) -> const float* {
        const bool q1 = half && q >= 16;
        const int iq = i0 + (half ? q & 15 : q);
        const bool ok = iq < (q1 ? size1 : size0);
        if constexpr (kGathered) {
          const int id = __shfl_sync(repro::kFullMask, idx, q);
          return ok ? src + static_cast<int64_t>(id) * D : nullptr;
        } else {
          return ok ? src + ((q1 ? in1 : in0) + iq) * D : nullptr;
        }
      };
      const auto row_out = [=](int q) -> float* {
        const bool q1 = half && q >= 16;
        const int iq = i0 + (half ? q & 15 : q);
        float* base = q1 ? eo1 : eo0;
        return iq < (q1 ? size1 : size0) && base != nullptr ? base + iq * D
                                                            : nullptr;
      };
      tile_load<D>(T, lane, row_in);
      if (q_due) {  // the first chunk: the query rows join the tile
#pragma unroll
        for (int u = 0; u < kQv; ++u) {
          const int f = lane + 32 * u;
          if (f < (pair ? 2 : 1) * D) {
            const int h = f >= D ? 1 : 0;
            Q[h * kLd + f - h * D] = qv[u];
          }
        }
      }
      __syncwarp();
      if (q_due) {
        q_due = false;
        if constexpr (!kQueryShared) load_tile(wd, 0, D, q_row, yq_regs);
      }
      if (has) {
        float delta[D];
        const float d2 = edge_delta<D, false>(wd, 0, D, q_row, yq, t_row,
                                              delta);
        float sc;
        ws += edge_scalars(mode, alpha, d2, cf, sc);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float e = edge_comp(mode, sc, delta[c]);
          t_row[c] = e;
          agg[c] += e;
        }
      }
      __syncwarp();
      tile_store<D>(T, lane, row_out);
      __syncwarp();  // the tile is read before the next chunk fills it
    }
    store_aggs<D>(agg, half, lane, agg_row);
    ws = round_sum(ws, half);
    if ((lane & (half ? 15 : 31)) == 0 && agg_row != nullptr) {
      const Half& me = mine1 ? h1 : h0;
      a.wsum[me.s * a.b + me.r] = ws;
    }
  }
}

// Whether rows of dd floats (the neighbour rows' source, every emitted edge
// block and the aggregates) allow `bytes`-wide accesses: the rounds route's
// vector loads and stores at d = 2 and 4, the staged route's float4 copies.
bool rows_allow(const EdgeArgs& a, int dd, int bytes) {
  const auto on = [&](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  if ((4 * dd) % bytes != 0 || !on(a.x != nullptr ? a.x : a.nbr)) return false;
  for (int s = 0; s < a.n_seg; ++s) {
    if (a.edge[s] != nullptr && !on(a.edge[s])) return false;
  }
  return on(a.agg);
}

template <int D>
int launch_rounds(const EdgeArgs& a, int d, cudaStream_t stream) {
  const Width<D> wd{d};
  const bool vec = (D == 2 || D == 4) && rows_allow(a, D, 4 * D);
  const Rounds rt = make_rounds(a);
  const int64_t units = rt.pair ? (a.b + 1) / 2 : a.b;
  if (units > 0) {
    const int64_t per_block =
        static_cast<int64_t>(kWarps) *
        (a.x != nullptr ? rounds_units<true>() : rounds_units<false>());
    const unsigned grid =
        static_cast<unsigned>((units + per_block - 1) / per_block);
    if (a.x != nullptr) {
      forces_rounds_kernel<D, true>
          <<<grid, kWarps * 32, 0, stream>>>(a, rt, wd, vec);
    } else {
      forces_rounds_kernel<D, false>
          <<<grid, kWarps * 32, 0, stream>>>(a, rt, wd, vec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_staged(const EdgeArgs& a, cudaStream_t stream) {
  const Rounds rt = make_rounds(a);
  const int64_t units = rt.pair ? (a.b + 1) / 2 : a.b;
  if (units > 0) {
    const unsigned grid =
        static_cast<unsigned>((units + kStagedWarps - 1) / kStagedWarps);
    if (a.x != nullptr) {
      forces_staged_kernel<D, true>
          <<<grid, kStagedWarps * 32, 0, stream>>>(a, rt);
    } else {
      forces_staged_kernel<D, false>
          <<<grid, kStagedWarps * 32, 0, stream>>>(a, rt);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// B7 (pre-gathered, x null) takes one segment a launch.
bool edge_args_ok(const EdgeArgs& a, int d) {
  return a.n_seg >= 1 && a.n_seg <= kMaxSeg && d >= 1 &&
         (a.x != nullptr || a.n_seg == 1);
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

extern "C" int repro_ne_forces_edges_rounds(const EdgeArgs* args, int d,
                                            cudaStream_t stream) {
  if (!edge_args_ok(*args, d) || d > kRoundsMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 1: return launch_rounds<1>(*args, d, stream);
    case 2: return launch_rounds<2>(*args, d, stream);
    case 3: return launch_rounds<3>(*args, d, stream);
    default: return launch_rounds<4>(*args, d, stream);
  }
}

// The staged route takes d = 8 and 32 with rows on 16 bytes (it copies
// them as float4s) and shuffles B5's row ids as 32-bit ints.
extern "C" int repro_ne_forces_edges_staged(const EdgeArgs* args, int d,
                                            cudaStream_t stream) {
  if (!edge_args_ok(*args, d) || !rows_allow(*args, d, 16) ||
      args->n > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 8: return launch_staged<8>(*args, stream);
    case 32: return launch_staged<32>(*args, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
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

