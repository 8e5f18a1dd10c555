// B2 and B4: neighbour refinement -- score, dedup and merge in one launch,
// B2 generating its candidates in the kernel, B4 reading a precomputed
// block.  One kernel body serves both (knn_merge_kernel<kPre>); the
// candidate source and the validity source are its compile-time choice.
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
// Bound of B2 on the H100: bytes.  HD: each query scores its candidate rows of X
// (784 floats each, 3 flops per float); x does not fit the 50 MB L2, so the
// gathered rows come from HBM (up to 70,000 x 11 rows x 3,136 B = 2.4 GB
// per launch when every candidate is new).  LD: about 40 MB of tables, a
// launch-overhead-sized kernel.
//
// Bound of B4 on the H100: bytes, as B2.  x is read once (219.5 MB at
// MNIST's shape) and the ids and distances add about 40 MB: 0.08 ms at
// 3.35 TB/s.  The candidate rows come from HBM, not the 50 MB L2: up to
// 70,000 x (1 + C) rows x 3,136 B per launch (NND, C = 16: 3.73 GB,
// 1.11 ms; FUnc-SNE HD, C = 10: 2.41 GB, 0.72 ms) when every candidate is
// new.
//
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
// entries): 40 KB a block at both bounds, inside the default 48 KB.
#include "common.cuh"

namespace {

constexpr int kMaxK = 1024;
constexpr int kMaxC = 128;
constexpr int kWarps = 4;
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
  int* base = smem + w * (2 * k + 4 * c);
  const WarpLists L{base, reinterpret_cast<float*>(base + k), base + 2 * k,
                    base + 2 * k + c,
                    reinterpret_cast<float*>(base + 2 * k + 2 * c),
                    base + 2 * k + 3 * c};
  const int row = a.qid[r];
  const int64_t q = repro::clamp_row(row, a.n);
  uint32_t salt = 0;  // B4 has no salt
  if constexpr (!kPre) salt = static_cast<uint32_t>(*a.salt);
  const uint32_t urow = static_cast<uint32_t>(row);
  const bool rescore = a.cur_d == nullptr;

  for (int i = lane; i < k; i += 32) {
    L.cur[i] = a.cur_idx[r * k + i];
    if (!rescore) L.cur_d[i] = a.cur_d[r * k + i];
  }
  for (int g = lane; g < c; g += 32) {
    int v;
    if constexpr (kPre) {
      v = a.cand[r * c + g];
    } else if (a.kind[g] == kUniform) {
      v = repro::counter_randint(salt, urow, 2 * g, static_cast<int>(a.n));
    } else if (a.kind[g] == kOneHop) {
      const int f = a.tab[g], fw = a.first_w[f];
      v = a.first[f][r * fw + repro::counter_randint(salt, urow, 2 * g, fw)];
    } else if (a.kind[g] == kTwoHop) {
      const int f = a.tab[g], s = a.sec[g], fw = a.first_w[f];
      const int64_t n2 = a.second_n[s];
      const int sw = a.second_w[s];
      int64_t mid =
          a.first[f][r * fw + repro::counter_randint(salt, urow, 2 * g, fw)];
      if (mid == repro::kSentinel) mid = row % n2;
      mid = repro::clamp_row(mid, n2);
      v = a.second[s][mid * sw +
                      repro::counter_randint(salt, urow, 2 * g + 1, sw)];
    } else {
      v = a.extra[r * a.extra_w + a.col[g]];
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

}  // namespace

// B2: candidates generated in the kernel.
extern "C" int repro_knn_merge_cand(const MergeArgs* args,
                                    cudaStream_t stream) {
  return launch<false>(args, stream);
}

// B4: candidates from the precomputed block.
extern "C" int repro_knn_merge(const MergeArgs* args, cudaStream_t stream) {
  return launch<true>(args, stream);
}
