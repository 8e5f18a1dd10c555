// B2 and B4: neighbour refinement -- score, dedup and merge in one launch,
// B2 generating its candidates in the kernel, B4 reading a precomputed
// block.  One kernel body serves both in each of three routes
// (knn_merge_kernel<kPre>, the warp route; knn_merge_lanes_kernel<kPre>,
// the lane route; knn_merge_ring_kernel<kPre, kSmall>, the ring route);
// the candidate source and the validity source are its compile-time
// choice, the route the wrapper's choice by shape.
//
// B2 replaces: src/repro/kernels/knn_merge/kernel.py, knn_merge_cand_pallas
//   (body _make_cand_kernel, slot layout _slot_plan, merge merge_select).
//   On the main path it runs twice per step: HD refinement on X
//   (70,000 x 784, K = 32, C = 10, stored distances) behind the gate, and
//   LD refinement on Y (70,000 x 2, K = 16, C = 8, current rows re-scored).
// B4 replaces: src/repro/kernels/knn_merge/kernel.py, knn_merge_pallas
//   (body _knn_merge_kernel).  It runs where the candidates come from
//   threefry: FUnc-SNE with cand_fused=False (HD on X, C = 10 or 14 with
//   reverse edges; LD rescore on Y, K = 16, C = 8) and nearest-neighbour
//   descent (X, K = 32, C = 16).  The candidates arrive as a (B, C) int32
//   block with an optional (B, C) bool validity block (active rows).
//
// Bound of B2 and B4 on the H100: bytes.  x read once (219.5 MB at
// MNIST's shape) and the ids and distances (about 40 MB): 0.08 ms at 3.35
// TB/s.  What a launch gathers is 1 + C rows of x a query at most (HD,
// C = 10: 2.1 GB at the main path's final state, 84% of the candidates
// new; NND, C = 16: 3.7 GB in its first iteration, 3.2 in its last).  On
// MNIST-like data most of those rows are L2 hits even when x's rows are
// shuffled: the warp route gathers them at 4.4-5.6 TB/s effective, the
// ring at 5.5-7.1; only K = 128's random initial lists are HBM-bound.
// LD: about 40 MB of tables, a launch-overhead-sized kernel.
//
// The lane route, rows of at most kLaneM = 8 floats with K + C <= 32 (the
// LD refinement): on the warp route such a row costs K + C warp-wide
// reductions in turn, each over 2 useful lanes at d = 2.  Here one lane
// holds one element of [current, candidates] and scores it alone, so the
// row's distances take one round trip; dedup is one __match_any_sync and
// the rank merge runs on shuffles (see knn_merge_lanes_kernel).  Its
// distances are bit for bit the warp route's (lane_sqdist, in
// row_sqdist.cuh, which B1's lane route shares).
//
// The ring route, rows of kRingMinM..kRingMaxM floats with M % 4 == 0 on
// a 16-byte-aligned x (HD refinement and NND at 784, K = 128): on the
// warp route a lane has at most 4 float4 pairs in flight (nvcc peels the
// row's loop into 1, 2, then 4 pairs), a row costs three dependent round
// trips, the C rows follow one another and the query row is read again for
// each.  Here the query row is read once into registers and lane 0 keeps
// a ring of whole candidate rows in shared memory filled by the TMA's 1-D
// bulk copies, so a warp has `stages` rows in flight; with K, C <= 32 the
// lists, dedup and merge live in registers and shuffles (see
// knn_merge_ring_kernel).  Its distances are bit for bit the warp route's
// (ring_score, in row_sqdist.cuh with the ring's constants, writes out
// warp_sqdist's roundings; B1's ring route shares it).  A block is
// kRingWarps = 4 warps with 2 stages each, 3 past kRingWideC = 12
// candidates (ring_stages): measured against more stages and warps, which
// cost more warps an SM than they gain.
//
// The warp route (everything else: narrow rows such as the latents' 16,
// dim_ld 32, widths with M % 4 != 0).
// Design: one warp per query row.  Lane g takes candidate slot g: B2
// generates it from the counter hash (slot g draws 2g and 2g+1, exactly
// the JAX sampler), B4 reads it from the block; then the dedup (self /
// in-list / earlier duplicate / SENTINEL / inactive or invalid) runs
// before any scoring, so candidates that cannot enter the list never cost
// a row read; the remaining rows are scored with the shared
// warp_row_sqdist (coalesced float4 loads).  Deduplication and merging see
// the raw ids; only scoring and the active lookup use the clipped ids.
// The merge ranks the <= K + C elements of [current, candidates] in
// registers: rank(e) = #{e' : d[e'] < d[e] or (d[e'] == d[e] and e' < e)},
// which is lax.top_k's tie rule (current before candidate, lower index
// first), and each element with rank < K is written to slot rank.
//
// Sizes: a warp's lists live in dynamic shared memory sized at launch,
// 4 (2K + 4C) bytes per warp, and its lanes stride over the C slots (lane g
// takes slots g, g + 32, ...), so K and C are bounded only by
// kMaxK = 1024 and kMaxC = 128 (the slot plan is a kernel argument of C
// entries): 40 KB a block at both bounds, inside the default 48 KB.  The
// ring adds `stages` rows and mbarriers and a schedule of K + C ints a warp
// (ring_warp_bytes): 106 KB a block of 4 warps at both bounds, 3 stages
// and M = 1,024, well inside kMaxSmem (a static_assert holds it); the
// launcher sizes the block and sets the kernel's shared-memory limit.
#include "common.cuh"
#include "hopper.cuh"
#include "row_sqdist.cuh"

namespace {

constexpr int kMaxK = 1024;
constexpr int kMaxC = 128;
constexpr int kWarps = 4;
constexpr int kLaneWarps = 8;
using repro::kLaneM;               // the routes' bounds (row_sqdist.cuh)
using repro::kRingChunks;
using repro::kRingMaxM;
using repro::kRingMinM;
using repro::kRingWarps;
using repro::lane_sqdist;
using repro::ring_score;
constexpr int kRingWideC = 12;     // past it, a third stage (ring_stages)
constexpr int64_t kMaxSmem = 232448;  // a block's dynamic shared memory
enum SlotKind { kUniform = 0, kOneHop = 1, kTwoHop = 2, kExtra = 3 };

}  // namespace

// Mirrored field for field by the ctypes Structure in
// repro_torch/kernels/knn_merge/ops.py.
struct MergeArgs {
  const float* x;
  int64_t n;
  int64_t m;
  const int* qid;
  int64_t b;
  const int* cur_idx;          // (B, K)
  const float* cur_d;          // (B, K) stored distances; null = rescore
  const uint8_t* cur_valid;    // (B, K) bool, rescore mode only
  int k;
  int c;
  const int* salt;             // device int32 scalar
  const uint8_t* active;       // (N,) bool, or null = all active
  const int* first[2];         // (B, first_w) tables
  const int* second[2];        // (second_n, second_w) tables
  const int* extra;            // (B, extra_w)
  const int* cand;             // B4: (B, C) precomputed candidates
  const uint8_t* cand_valid;   // B4: (B, C) bool, or null = all valid
  int64_t second_n[2];
  int first_w[2];
  int second_w[2];
  int extra_w;
  int kind[kMaxC];             // SlotKind per slot
  int tab[kMaxC];              // first-table index (one/two hop)
  int sec[kMaxC];              // second-table index (two hop)
  int col[kMaxC];              // extra column
  int* new_idx;                // (B, K)
  float* new_d;                // (B, K)
  uint8_t* improved;           // (B,) bool
};

namespace {

// A warp's slice of the dynamic shared memory: the current list (ids,
// distances) and the candidates (raw ids, clipped ids, distances, validity).
struct WarpLists {
  int* cur;
  float* cur_d;
  int* cand;
  int* gat;
  float* cand_d;
  int* ok;
};

__host__ __device__ inline size_t warp_smem_bytes(int k, int c) {
  return sizeof(int) * (2 * static_cast<size_t>(k) + 4 * static_cast<size_t>(c));
}

// Candidate slot g of row r, generated (B2) as the JAX sampler draws it:
// slot g takes draws 2g and 2g + 1 of the counter hash of (salt, row).
__device__ __forceinline__ int candidate(const MergeArgs& a, int64_t r, int g,
                                         int kind, int f, int s, int col,
                                         uint32_t salt, int row) {
  const uint32_t urow = static_cast<uint32_t>(row);
  if (kind == kUniform) {
    return repro::counter_randint(salt, urow, 2 * g, static_cast<int>(a.n));
  }
  if (kind == kOneHop) {
    const int fw = a.first_w[f];
    return a.first[f][r * fw + repro::counter_randint(salt, urow, 2 * g, fw)];
  }
  if (kind == kTwoHop) {
    const int fw = a.first_w[f];
    const int64_t n2 = a.second_n[s];
    const int sw = a.second_w[s];
    int64_t mid =
        a.first[f][r * fw + repro::counter_randint(salt, urow, 2 * g, fw)];
    if (mid == repro::kSentinel) mid = row % n2;
    mid = repro::clamp_row(mid, n2);
    return a.second[s][mid * sw +
                       repro::counter_randint(salt, urow, 2 * g + 1, sw)];
  }
  return a.extra[r * a.extra_w + col];
}

// The current list, the candidates (B2 generated, B4 read; kPre as in
// knn_merge_kernel) and their validity `ok`: the dedup (self / in-list /
// earlier duplicate / SENTINEL / inactive or invalid) runs before any
// scoring, so candidates that cannot enter the list never cost a row read.
// Both wide-row routes run it; it ends with the warp synchronised.
template <bool kPre>
__device__ __forceinline__ void fill_lists(const MergeArgs& a,
                                           const WarpLists& L, int64_t r,
                                           int row, int lane) {
  const int k = a.k, c = a.c;
  uint32_t salt = 0;  // B4 has no salt
  if constexpr (!kPre) salt = static_cast<uint32_t>(*a.salt);
  for (int i = lane; i < k; i += 32) {
    L.cur[i] = a.cur_idx[r * k + i];
    if (a.cur_d != nullptr) L.cur_d[i] = a.cur_d[r * k + i];
  }
  for (int g = lane; g < c; g += 32) {
    int v;
    if constexpr (kPre) {
      v = a.cand[r * c + g];
    } else {
      v = candidate(a, r, g, a.kind[g], a.tab[g], a.sec[g], a.col[g], salt,
                    row);
    }
    L.cand[g] = v;
    L.gat[g] = static_cast<int>(repro::clamp_row(v, a.n));
  }
  __syncwarp();

  // dedup before scoring: an invalid candidate is +inf and is never read
  for (int g = lane; g < c; g += 32) {
    const int v = L.cand[g];
    bool valid = v != repro::kSentinel && v != row;
    if constexpr (kPre) {
      if (a.cand_valid != nullptr) valid = valid && a.cand_valid[r * c + g];
    } else if (a.active != nullptr) {
      valid = valid && a.active[L.gat[g]];
    }
    for (int i = 0; i < k; ++i) valid = valid && v != L.cur[i];
    for (int j = 0; j < g; ++j) valid = valid && v != L.cand[j];
    L.ok[g] = valid;
  }
  __syncwarp();
}

// `improved` and the rank merge of the scored lists, written to row r.
__device__ __forceinline__ void merge_lists(const MergeArgs& a,
                                            const WarpLists& L, int64_t r,
                                            int lane) {
  const int k = a.k, c = a.c;
  bool imp = false;
  for (int g = lane; g < c; g += 32) imp = imp || L.cand_d[g] < L.cur_d[k - 1];
  const unsigned imask = __ballot_sync(repro::kFullMask, imp);
  if (lane == 0) a.improved[r] = imask != 0u;

  const int total = k + c;
  for (int e = lane; e < total; e += 32) {
    const float de = e < k ? L.cur_d[e] : L.cand_d[e - k];
    int rank = 0;
    for (int j = 0; j < total; ++j) {
      const float dj = j < k ? L.cur_d[j] : L.cand_d[j - k];
      rank += (dj < de) || (dj == de && j < e);
    }
    if (rank < k) {
      a.new_idx[r * k + rank] = e < k ? L.cur[e] : L.cand[e - k];
      a.new_d[r * k + rank] = de;
    }
  }
}

__device__ __forceinline__ WarpLists warp_lists(int* base, int k, int c) {
  return WarpLists{base, reinterpret_cast<float*>(base + k), base + 2 * k,
                   base + 2 * k + c,
                   reinterpret_cast<float*>(base + 2 * k + 2 * c),
                   base + 2 * k + 3 * c};
}

// kPre: candidates and their validity from the (B, C) blocks (B4), else
// generated from the slot plan and checked against `active` (B2).
template <bool kPre>
__global__ void __launch_bounds__(kWarps * 32)
    knn_merge_kernel(const MergeArgs a, bool vec4) {
  extern __shared__ int smem[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (r >= a.b) return;  // uniform per warp
  const int k = a.k, c = a.c;
  const WarpLists L = warp_lists(smem + w * (2 * k + 4 * c), k, c);
  const int row = a.qid[r];
  const int64_t q = repro::clamp_row(row, a.n);
  const bool rescore = a.cur_d == nullptr;
  fill_lists<kPre>(a, L, r, row, lane);

  for (int g = 0; g < c; ++g) {
    float d = INFINITY;
    if (L.ok[g]) {
      d = repro::warp_row_sqdist(a.x, a.m, q, L.gat[g], lane, vec4);
    }
    if (lane == 0) L.cand_d[g] = d;
  }
  if (rescore) {
    for (int i = 0; i < k; ++i) {
      float d = INFINITY;
      if (a.cur_valid[r * k + i]) {
        d = repro::warp_row_sqdist(a.x, a.m, q,
                                   repro::clamp_row(L.cur[i], a.n), lane,
                                   vec4);
      }
      if (lane == 0) L.cur_d[i] = d;
    }
  }
  __syncwarp();
  merge_lists(a, L, r, lane);
}

// A warp's slice of the ring route's dynamic shared memory, in bytes:
// `stages` rows of m floats, their mbarriers, the lists of the warp route,
// and the schedule of rows to score (K + C ints); 16-byte aligned, so that
// every warp's ring is.
__host__ __device__ constexpr int64_t ring_warp_bytes(int64_t m, int k, int c,
                                                      int stages) {
  return (stages * (4 * m + 8) +
          4 * (3 * static_cast<int64_t>(k) + 5 * static_cast<int64_t>(c)) +
          15) / 16 * 16;
}

// The ring's stages a warp: 2, and 3 past kRingWideC candidates (NND's 16,
// K = 128's 64: more rows to score a query row).
constexpr int ring_stages(int c) { return c > kRingWideC ? 3 : 2; }

static_assert(kRingWarps * ring_warp_bytes(kRingMaxM, kMaxK, kMaxC,
                                           ring_stages(kMaxC)) <= kMaxSmem,
              "the ring route's block must fit at K, C and M's bounds");

// The ring route: one warp per query row, as the warp route, with up to
// `stages` candidate rows in flight (ring_score).  The query row is loaded
// once into registers, first, so that its loads overlap the lists'.
//
// kSmall (K <= 32 and C <= 32: HD refinement and NND): the lists live in
// registers, lane i holding current element i and candidate i.  The dedup
// is the warp route's test on the same raw ids, by shuffles (in-list) and
// one __match_any_sync (earlier duplicate); the merge ranks each element by
// the warp route's formula, rank(e) = #{e' : d[e'] < d[e] or (d[e'] ==
// d[e] and e' < e)}, over the others' distances read by shuffles, K + C
// steps a lane instead of K + C per element.  Otherwise (long lists) the
// lists and the merge are the warp route's, in shared memory.  The rows to
// score (the candidates that may enter, then in rescore mode the valid
// current rows) are listed in order; the rest are +inf.  Every
// warp-collective call runs in all 32 lanes: none sits behind a condition,
// such as a short circuit, that differs between lanes.
template <bool kPre, bool kSmall>
__global__ void __launch_bounds__(kRingWarps * 32)
    knn_merge_ring_kernel(const MergeArgs a, int stages) {
  extern __shared__ __align__(16) unsigned char ring_smem[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRingWarps + w;
  if (r >= a.b) return;  // uniform per warp; no block-wide barrier follows
  const int k = a.k, c = a.c;
  const int m = static_cast<int>(a.m), nv = m >> 2;
  unsigned char* mine = ring_smem + w * ring_warp_bytes(m, k, c, stages);
  float* ring = reinterpret_cast<float*>(mine);
  const uint32_t bar0 = hopper::smem_u32(mine + 4 * stages * m);
  int* base = reinterpret_cast<int*>(mine + stages * (4 * m + 8));
  int* sched = base + 2 * k + 4 * c;
  const int row = a.qid[r];
  const int64_t q = repro::clamp_row(row, a.n);
  const bool rescore = a.cur_d == nullptr;

  const float4* xq = reinterpret_cast<const float4*>(a.x + q * a.m);
  float4 qv[kRingChunks];
#pragma unroll
  for (int u = 0; u < kRingChunks; ++u) {
    if (lane + 32 * u < nv) qv[u] = __ldg(xq + lane + 32 * u);
  }
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const unsigned below = (1u << lane) - 1u;

  if constexpr (kSmall) {
    const bool is_cur = lane < k, is_cand = lane < c;
    int cur = repro::kSentinel, v = repro::kSentinel, gat = 0;
    float cur_d = INFINITY;
    if (is_cur) {
      cur = a.cur_idx[r * k + lane];
      if (!rescore) cur_d = a.cur_d[r * k + lane];
    }
    bool ok = false;
    if (is_cand) {
      if constexpr (kPre) {
        v = a.cand[r * c + lane];
      } else {
        v = candidate(a, r, lane, a.kind[lane], a.tab[lane], a.sec[lane],
                      a.col[lane], static_cast<uint32_t>(*a.salt), row);
      }
      gat = static_cast<int>(repro::clamp_row(v, a.n));
      ok = v != repro::kSentinel && v != row;
      if constexpr (kPre) {
        if (a.cand_valid != nullptr) ok = ok && a.cand_valid[r * c + lane];
      } else if (a.active != nullptr) {
        ok = ok && a.active[gat];
      }
    }
    // in the list, or an earlier candidate's raw id (lanes past C hold
    // SENTINEL, and only lower lanes count)
    for (int i = 0; i < k; ++i) {
      const int ci = __shfl_sync(repro::kFullMask, cur, i);
      ok = ok && v != ci;
    }
    const unsigned same = __match_any_sync(repro::kFullMask, v);
    ok = ok && (same & below) == 0u;

    float* dist = reinterpret_cast<float*>(base);  // the j-th scored row's
    const unsigned cmask = __ballot_sync(repro::kFullMask, ok);
    const int nc = __popc(cmask);
    const int cpos = __popc(cmask & below);
    if (ok) sched[cpos] = gat;
    bool live = false;
    int lpos = 0, n = nc;
    if (rescore) {
      live = is_cur && a.cur_valid[r * k + lane];
      const unsigned lmask = __ballot_sync(repro::kFullMask, live);
      lpos = nc + __popc(lmask & below);
      if (live) sched[lpos] = static_cast<int>(repro::clamp_row(cur, a.n));
      n += __popc(lmask);
    }
    __syncwarp();
    ring_score(a.x, a.m, ring, bar0, stages, n, qv, lane,
               [&](int j) { return sched[j]; },
               [&](int j, float d) { dist[j] = d; });
    const float cand_d = ok ? dist[cpos] : INFINITY;
    if (rescore) cur_d = live ? dist[lpos] : INFINITY;

    const float worst = __shfl_sync(repro::kFullMask, cur_d, k - 1);
    const unsigned imask =
        __ballot_sync(repro::kFullMask, is_cand && cand_d < worst);
    if (lane == 0) a.improved[r] = imask != 0u;
    int rank_cur = 0, rank_cand = 0;
    for (int j = 0; j < k; ++j) {  // current element j (before every cand)
      const float dj = __shfl_sync(repro::kFullMask, cur_d, j);
      rank_cur += (dj < cur_d) || (dj == cur_d && j < lane);
      rank_cand += (dj < cand_d) || (dj == cand_d);
    }
    for (int g = 0; g < c; ++g) {  // candidate g (after every current)
      const float dg = __shfl_sync(repro::kFullMask, cand_d, g);
      rank_cur += dg < cur_d;
      rank_cand += (dg < cand_d) || (dg == cand_d && g < lane);
    }
    if (is_cur && rank_cur < k) {
      a.new_idx[r * k + rank_cur] = cur;
      a.new_d[r * k + rank_cur] = cur_d;
    }
    if (is_cand && rank_cand < k) {
      a.new_idx[r * k + rank_cand] = v;
      a.new_d[r * k + rank_cand] = cand_d;
    }
  } else {
    const WarpLists L = warp_lists(base, k, c);
    fill_lists<kPre>(a, L, r, row, lane);
    int n = 0;  // sched[j]: the index in [cur, cand] of the j-th scored row
    for (int g0 = 0; g0 < c; g0 += 32) {
      const int g = g0 + lane;
      const bool take = g < c && L.ok[g];
      if (g < c) L.cand_d[g] = INFINITY;
      const unsigned mask = __ballot_sync(repro::kFullMask, take);
      if (take) sched[n + __popc(mask & below)] = k + g;
      n += __popc(mask);
    }
    if (rescore) {
      for (int i0 = 0; i0 < k; i0 += 32) {
        const int i = i0 + lane;
        const bool take = i < k && a.cur_valid[r * k + i];
        if (i < k) L.cur_d[i] = INFINITY;
        const unsigned mask = __ballot_sync(repro::kFullMask, take);
        if (take) sched[n + __popc(mask & below)] = i;
        n += __popc(mask);
      }
    }
    __syncwarp();
    ring_score(
        a.x, a.m, ring, bar0, stages, n, qv, lane,
        [&](int j) {
          const int e = sched[j];
          return e < k ? static_cast<int>(repro::clamp_row(L.cur[e], a.n))
                       : L.gat[e - k];
        },
        [&](int j, float d) {
          const int e = sched[j];
          if (e < k) {
            L.cur_d[e] = d;
          } else {
            L.cand_d[e - k] = d;
          }
        });
    merge_lists(a, L, r, lane);
  }
}

template <bool kPre>
int launch(const MergeArgs* args, cudaStream_t stream) {
  if (args->k < 1 || args->k > kMaxK || args->c < 1 || args->c > kMaxC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args->b > 0) {
    const int64_t blocks = (args->b + kWarps - 1) / kWarps;
    const size_t smem = kWarps * warp_smem_bytes(args->k, args->c);
    knn_merge_kernel<kPre><<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                             stream>>>(*args,
                                       repro::can_vec4(args->x, args->m));
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kPre>
int launch_ring(const MergeArgs* args, cudaStream_t stream) {
  const int64_t m = args->m;
  if (args->k < 1 || args->k > kMaxK || args->c < 1 || args->c > kMaxC ||
      m < kRingMinM || m > kRingMaxM || !repro::can_vec4(args->x, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args->b > 0) {
    const int stages = ring_stages(args->c);
    const int64_t smem =
        kRingWarps * ring_warp_bytes(m, args->k, args->c, stages);
    const auto kernel = args->k <= 32 && args->c <= 32
                            ? knn_merge_ring_kernel<kPre, true>
                            : knn_merge_ring_kernel<kPre, false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t blocks = (args->b + kRingWarps - 1) / kRingWarps;
    kernel<<<static_cast<unsigned>(blocks), kRingWarps * 32,
             static_cast<size_t>(smem), stream>>>(*args, stages);
  }
  return static_cast<int>(cudaGetLastError());
}

// The lane route (m <= kLaneM, K + C <= 32): lane e holds element e of
// [current list, candidates] -- its raw id, its validity and its distance,
// scored by the lane itself -- so the row's distances take one round trip
// instead of K + C warp reductions in turn.  A candidate is a duplicate
// when a lower lane (the current list, then the earlier candidates) holds
// the same raw id: one __match_any_sync.  Each lane ranks its element by
// the tie rule of the warp route over the others' distances, read by
// shuffles, and writes it to slot rank if rank < K.  B2's slot plan is
// copied to shared memory once a block, so the lanes do not read kernel
// parameters at lane-dependent indices.
template <bool kPre>
__global__ void __launch_bounds__(kLaneWarps * 32)
    knn_merge_lanes_kernel(const MergeArgs a, bool vec4) {
  __shared__ int plan[32];  // B2: kind | tab << 2 | sec << 3 | col << 4
  if constexpr (!kPre) {
    for (int g = threadIdx.x; g < a.c; g += blockDim.x)
      plan[g] = a.kind[g] | a.tab[g] << 2 | a.sec[g] << 3 | a.col[g] << 4;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kLaneWarps + (threadIdx.x >> 5);
  if (r >= a.b) return;  // uniform per warp
  const int k = a.k, c = a.c, total = k + c;
  const bool cur = lane < k, live = lane < total;
  const int g = lane - k;
  const int row = a.qid[r];
  const int64_t q = repro::clamp_row(row, a.n);
  const bool rescore = a.cur_d == nullptr;

  int v = repro::kSentinel;
  if (cur) {
    v = a.cur_idx[r * k + lane];
  } else if (live) {
    if constexpr (kPre) {
      v = a.cand[r * c + g];
    } else {
      const int pl = plan[g];
      v = candidate(a, r, g, pl & 3, (pl >> 2) & 1, (pl >> 3) & 1, pl >> 4,
                    static_cast<uint32_t>(*a.salt), row);
    }
  }
  const int64_t t = repro::clamp_row(v, a.n);
  const unsigned lower =
      __match_any_sync(repro::kFullMask, v) & ((1u << lane) - 1u);
  bool ok;
  if (cur) {
    ok = !rescore || a.cur_valid[r * k + lane];
  } else {
    ok = live && v != repro::kSentinel && v != row && lower == 0u;
    if constexpr (kPre) {
      if (a.cand_valid != nullptr) ok = ok && a.cand_valid[r * c + g];
    } else if (a.active != nullptr) {
      ok = ok && a.active[t];
    }
  }
  float d = INFINITY;
  if (cur && !rescore) {
    d = a.cur_d[r * k + lane];
  } else if (ok) {
    d = lane_sqdist(a.x + q * a.m, a.x + t * a.m, static_cast<int>(a.m), vec4);
  }

  const float worst = __shfl_sync(repro::kFullMask, d, k - 1);
  const unsigned imask =
      __ballot_sync(repro::kFullMask, live && !cur && d < worst);
  if (lane == 0) a.improved[r] = imask != 0u;
  int rank = 0;
  for (int j = 0; j < total; ++j) {
    const float dj = __shfl_sync(repro::kFullMask, d, j);
    rank += (dj < d) || (dj == d && j < lane);
  }
  if (live && rank < k) {
    a.new_idx[r * k + rank] = v;
    a.new_d[r * k + rank] = d;
  }
}

template <bool kPre>
int launch_lanes(const MergeArgs* args, cudaStream_t stream) {
  if (args->k < 1 || args->c < 1 || args->k + args->c > 32 || args->m < 1 ||
      args->m > kLaneM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args->b > 0) {
    const int64_t blocks = (args->b + kLaneWarps - 1) / kLaneWarps;
    knn_merge_lanes_kernel<kPre>
        <<<static_cast<unsigned>(blocks), kLaneWarps * 32, 0, stream>>>(
            *args, repro::can_vec4(args->x, args->m));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B2: candidates generated in the kernel; the warp route.
extern "C" int repro_knn_merge_cand(const MergeArgs* args,
                                    cudaStream_t stream) {
  return launch<false>(args, stream);
}

// B2, the lane route (m <= 8, K + C <= 32).
extern "C" int repro_knn_merge_cand_lanes(const MergeArgs* args,
                                          cudaStream_t stream) {
  return launch_lanes<false>(args, stream);
}

// B2, the ring route (128 <= m <= 1024, m % 4 == 0, x 16-byte aligned).
extern "C" int repro_knn_merge_cand_ring(const MergeArgs* args,
                                         cudaStream_t stream) {
  return launch_ring<false>(args, stream);
}

// B4: candidates from the precomputed block; the warp route.
extern "C" int repro_knn_merge(const MergeArgs* args, cudaStream_t stream) {
  return launch<true>(args, stream);
}

// B4, the lane route (m <= 8, K + C <= 32).
extern "C" int repro_knn_merge_lanes(const MergeArgs* args,
                                     cudaStream_t stream) {
  return launch_lanes<true>(args, stream);
}

// B4, the ring route (as B2's).
extern "C" int repro_knn_merge_ring(const MergeArgs* args,
                                    cudaStream_t stream) {
  return launch_ring<true>(args, stream);
}
