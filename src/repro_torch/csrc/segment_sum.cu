// Deterministic row sums of scattered rows: FUnc-SNE's symmetrisation on
// the unfused force paths (scatter_fused=False with B5, gather_fused=False
// with B7).
//
// Replaces: the `.at[].add` scatters of src/repro/core/funcsne.py:732-738
//   (XLA's scatter-add, not a Pallas kernel), which the port first ran as
//   index_add_: float atomics whose order, and so whose last bits, changed
//   from run to run on the card.
// out[i, :] = sum of val[e, :] over the e with idx[e] == i, added in
//   increasing e -- the order of a sequential index_add_, so the result is
//   the CPU plain version's bit for bit and repeats exactly.
// On those paths it runs once per step over n + n (k_hd + k_ld) rows of d
//   floats (70,000 x 49 rows at MNIST's shape).
//
// Bound on the H100: bytes.  idx (int32) and val are read once (E x (4 +
//   4 d) B) and out written once; a few flops per element.
//
// Design: a stable counting sort by row in two levels, which carries the
// values with the ids, then each row's values added in order.  No sort of
// all E keys, no per-row sort, and no global atomic per id (on the H100 a
// pass of one global atomic per id, for a count or for a slot, cost about
// as much as index_add_'s whole call): every placement is by counts, so
// each row's values arrive in increasing e.
//   Rows fall into groups of G = 128 rows (more above 262,144 rows: at
//   most 2,048 groups); ids into chunks of kChunkIds = 4,608, one block
//   each, whose 16 warps take 288 consecutive ids each, 32 at a time
//   (at MNIST's 3.43 M ids, 745 blocks: three waves of two blocks an SM
//   on an H100's 132 SMs, where chunks of 4,096 took four).
//   pass 0, count: a block counts its chunk's ids by group in shared
//     memory: the matrix H of counts (chunk x group);
//   pass 1, scan: each group's counts are scanned over the chunks (where
//     in the group each chunk's ids go), then the groups' totals (where
//     each group starts); the groups of more than 1.5 times the mean
//     group's ids are put first in pass 3's order;
//   pass 2, place: a block ranks its ids within their group in e order.
//     Each warp counts its ids by group (shared-memory atomics), the
//     counters are scanned over groups and warps, then each warp walks its
//     ids again in the same order and puts each at its group's start plus
//     its warp's offset plus the earlier lanes of its group (the lanes of
//     a group found by one ballot a bit of the group number).  The rows
//     and, for d <= kValsD, the values (loaded coalesced in the first
//     walk) are staged in shared memory in that order, then copied to the
//     group's run, after the earlier chunks' part: consecutive threads
//     write consecutive words.  For wider d the ids are staged and their
//     values gathered at the copy, consecutive threads taking consecutive
//     words of an id;
//   pass 3, order and sum: one block per group, the heavy groups' blocks
//     first (a hub group's block takes two to three times the mean, and
//     launched last it set the pass's end), ranks its ids by row the
//     same way (16 warps, each a contiguous part of the group's run), so
//     each row gets the positions of its values in increasing e.  With d
//     <= kValsD and at most kGroupCap ids, the second walk loads each
//     id's values with its row and stores them at its rank in shared
//     memory, so each row's values lie in order, and every row is added
//     at once, one thread a (row, column): only the FADD chain of a row is
//     serial.  Wider rows, and a group past kGroupCap ids (hubs of the
//     kNN graph), write the ranks' positions to global scratch and go in
//     passes over the group's ranks, kStageFloats values a pass gathered
//     in rank order into shared memory; a row that spans passes carries
//     its sum in out from one pass to the next.
// kernels/segment_sum/ops.py: work_ints mirrors the workspace.
// tests/test_torch_segment_csr.py: segment_runs is this ordering in plain
// PyTorch, held to the stable sort.
#include <climits>

#include "common.cuh"

// Mirrored field for field by the ctypes Structure in
// repro_torch/kernels/segment_sum/ops.py.
struct SegmentArgs {
  const float* val;      // (E, d)
  const int32_t* idx;    // (E,) row ids in [0, n)
  int32_t* work;         // workspace: ops.work_ints(n, E, d) int32
  float* out;            // (n, d)
  int64_t e;             // E
  int n;
  int d;
};

namespace {

constexpr int kMinGroupBits = 7;   // groups of 128 rows at least
constexpr int kMaxGroupBits = 10;  // and at most 1,024
constexpr int kMaxGroups = 2048;
constexpr int kPlaceWarps = 16;    // warps of a block in passes 0 and 2
constexpr int kPlaceThreads = 32 * kPlaceWarps;
constexpr int kPlaceBlocks = 2;    // blocks an SM of the place pass (registers)
constexpr int kWarpIds = 288;      // consecutive ids of a warp in a chunk
constexpr int kChunkIds = kPlaceWarps * kWarpIds;
constexpr int kGroupWarps = 16;    // warps of a block in pass 3
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kGroupCap = 12288;   // ids of a group held in shared memory
constexpr int kScanGroups = 8;     // groups of a block of the column scan
constexpr int kSegs = 128;         // its chunk segments, one per thread
constexpr int kScanBatch = 8;      // counts a thread loads at once
constexpr int kCopy = 8;           // values a thread copies out at once
constexpr int kValsD = 2;          // widths whose values are staged
constexpr int kStageFloats = kGroupCap * kValsD;  // values pass 3 holds
constexpr int kWalk = 16;          // steps of 32 ids a warp loads at once
constexpr int kGather = 8;         // values a thread gathers at once

__host__ __device__ inline int n_groups(int n, int gbits) {
  return static_cast<int>((static_cast<int64_t>(n) + (1 << gbits) - 1) >>
                          gbits);
}

__host__ __device__ inline int group_bits(int n) {
  int b = kMinGroupBits;
  while (b <= kMaxGroupBits && n_groups(n, b) > kMaxGroups) ++b;
  return b;
}

__host__ __device__ inline int n_chunks(int64_t e) {
  return static_cast<int>((e + kChunkIds - 1) / kChunkIds);
}

// The workspace (int32 words; mirrored by ops.work_ints): the groups'
// totals, starts (+ 1) and order for pass 3; H and its scan over chunks
// (chunks x groups each); the positions of the large groups' ranks (E);
// the values by group (E x d floats); the rows within their group (E
// uint16).
struct Work {
  int gbits;
  int ng;
  int ng_bits;   // bits of a group number
  int nb;
  int32_t* total;
  int32_t* gstart;
  int32_t* order;
  int32_t* hist;
  int32_t* hpre;
  int32_t* slots;
  float* seg_v;
  uint16_t* seg_r;
};

inline Work split_work(int32_t* w, int n, int64_t e, int d) {
  Work s;
  s.gbits = group_bits(n);
  s.ng = n_groups(n, s.gbits);
  s.ng_bits = 0;
  while ((1 << s.ng_bits) < s.ng) ++s.ng_bits;
  s.nb = n_chunks(e);
  const int64_t cells = static_cast<int64_t>(s.nb) * s.ng;
  s.total = w;
  s.gstart = s.total + s.ng;
  s.order = s.gstart + s.ng + 1;
  s.hist = s.order + s.ng;
  s.hpre = s.hist + cells;
  s.slots = s.hpre + cells;
  s.seg_v = reinterpret_cast<float*>(s.slots + e);
  s.seg_r = reinterpret_cast<uint16_t*>(s.seg_v + e * d);
  return s;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The lanes of the warp whose key equals this lane's, keys in [0, 2^bits)
// or -1 for none (whose result is not used): one ballot a key bit.
__device__ __forceinline__ unsigned match_key(int key, int bits) {
  unsigned peers = __ballot_sync(repro::kFullMask, key >= 0);
  for (int b = 0; b < bits; ++b) {
    const bool bit = (key >> b) & 1;
    const unsigned m = __ballot_sync(repro::kFullMask, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// Exclusive scan of in[0, m) into out[0, m) (in place allowed) by the
// whole block, m at most 8 blockDim.x; returns the total to every thread.
// tmp: 32 ints of shared memory.
__device__ int32_t block_scan(const int32_t* in, int32_t* out, int m,
                              int32_t* tmp) {
  const int t = threadIdx.x, lane = t % 32, wi = t / 32;
  const int nw = blockDim.x / 32;
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int i0 = t * per;
  int32_t v[8];
  int32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = j < per && i0 + j < m ? in[i0 + j] : 0;
    s += v[j];
  }
  int32_t x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(repro::kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[wi] = x;
  __syncthreads();
  if (wi == 0) {
    int32_t y = lane < nw ? tmp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t z = __shfl_up_sync(repro::kFullMask, y, o);
      if (lane >= o) y += z;
    }
    if (lane < nw) tmp[lane] = y;
  }
  __syncthreads();
  int32_t run = (wi > 0 ? tmp[wi - 1] : 0) + x - s;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < per && i0 + j < m) out[i0 + j] = run;
    run += v[j];
  }
  const int32_t total = tmp[nw - 1];
  __syncthreads();                   // tmp and in are free again
  return total;
}

// The row of id i of a chunk that ends at e1, or -1 for an id past it or
// outside [0, n).  The count pass's loads leave the ids in L2 for the
// place pass, whose loads are their last (evict first).
template <bool kLast>
__device__ __forceinline__ int id_row(const int32_t* __restrict__ idx,
                                      int64_t i, int64_t e1, int n) {
  if (i >= e1) return -1;
  const int r = kLast ? __ldcs(idx + i) : __ldg(idx + i);
  return r >= 0 && r < n ? r : -1;
}

// Pass 0: the groups' counts of one chunk (H's row), in shared memory,
// every id's load in flight at once.
__global__ void __launch_bounds__(kPlaceThreads)
    count_kernel(const int32_t* __restrict__ idx, int64_t e, int n, Work w) {
  extern __shared__ int32_t sh[];
  for (int g = threadIdx.x; g < w.ng; g += blockDim.x) sh[g] = 0;
  __syncthreads();
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kChunkIds;
  const int64_t e1 = min(e, e0 + kChunkIds);
  constexpr int kSteps = kChunkIds / kPlaceThreads;
  int rows[kSteps];
#pragma unroll
  for (int it = 0; it < kSteps; ++it)
    rows[it] = id_row<false>(idx, e0 + it * kPlaceThreads + threadIdx.x, e1, n);
#pragma unroll
  for (int it = 0; it < kSteps; ++it)
    if (rows[it] >= 0) atomicAdd(sh + (rows[it] >> w.gbits), 1);
  __syncthreads();
  int32_t* h = w.hist + static_cast<int64_t>(blockIdx.x) * w.ng;
  for (int g = threadIdx.x; g < w.ng; g += blockDim.x) h[g] = sh[g];
}

// Pass 1a: H scanned over the chunks, per group (hpre), and the groups'
// totals.  A block takes kScanGroups groups; thread (s, lane) sums chunk
// segment s of group lane, kScanBatch counts loaded at once, then writes
// that segment's scan.
__global__ void __launch_bounds__(kScanGroups * kSegs)
    column_scan_kernel(Work w) {
  __shared__ int32_t part[kSegs][kScanGroups + 1];
  const int lane = threadIdx.x % kScanGroups, s = threadIdx.x / kScanGroups;
  const int g = blockIdx.x * kScanGroups + lane;
  const int per = (w.nb + kSegs - 1) / kSegs;
  const int b0 = s * per, b1 = min(w.nb, b0 + per);
  int32_t sum = 0;
  if (g < w.ng) {
    for (int b = b0; b < b1; b += kScanBatch) {
      int32_t h[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u)
        h[u] = b + u < b1 ? w.hist[static_cast<int64_t>(b + u) * w.ng + g] : 0;
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) sum += h[u];
    }
  }
  part[s][lane] = sum;
  __syncthreads();
  int32_t run = 0;
  for (int q = 0; q < s; ++q) run += part[q][lane];
  if (g < w.ng) {
    for (int b = b0; b < b1; b += kScanBatch) {
      int32_t h[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u)
        h[u] = b + u < b1 ? w.hist[static_cast<int64_t>(b + u) * w.ng + g] : 0;
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        if (b + u < b1) w.hpre[static_cast<int64_t>(b + u) * w.ng + g] = run;
        run += h[u];
      }
    }
    if (s == kSegs - 1) w.total[g] = run;
  }
}

// Pass 1b: the group totals into group starts gstart[0, ng], and pass 3's
// order of the groups: those of more than `heavy` ids first (hubs of the
// kNN graph: their blocks take longest, so they start in the first wave),
// then the rest, each class in group order.
__global__ void __launch_bounds__(1024) group_scan_kernel(Work w,
                                                           int heavy) {
  __shared__ int32_t tmp[32];
  __shared__ int32_t before[kMaxGroups];   // heavy groups before each
  const int32_t total = block_scan(w.total, w.gstart, w.ng, tmp);
  if (threadIdx.x == 0) w.gstart[w.ng] = total;
  for (int g = threadIdx.x; g < w.ng; g += blockDim.x)
    before[g] = w.total[g] > heavy;
  __syncthreads();
  const int32_t n_heavy = block_scan(before, before, w.ng, tmp);
  for (int g = threadIdx.x; g < w.ng; g += blockDim.x)
    w.order[w.total[g] > heavy ? before[g] : n_heavy + g - before[g]] = g;
}

// Pass 2: the chunk's ids ranked within their groups in e order, staged,
// and copied with their values and rows to the groups' runs.  Shared
// memory: the groups' local starts and global bases (ng ints each), the
// staged rows (kChunkIds ints), the staged values (kVals: kChunkIds x
// kValsD floats, loaded coalesced in the first walk) or ids (their values
// gathered at the copy), the warps' counters (kPlaceWarps x ng uint16).
template <bool kVals>
__global__ void __launch_bounds__(kPlaceThreads, kPlaceBlocks)
    place_kernel(const SegmentArgs a, Work w) {
  extern __shared__ int32_t sh[];
  __shared__ int32_t tmp[32];
  const int32_t* idx = a.idx;
  const int ng = w.ng, d = a.d, lane = threadIdx.x % 32, wi = threadIdx.x / 32;
  constexpr int kStaged = kVals ? kValsD : 1;      // words an id stages
  int32_t* lstart = sh;
  int32_t* gbase = sh + ng;
  int32_t* st_r = sh + 2 * ng;
  int32_t* st_x = st_r + kChunkIds;               // values, or ids
  // counters (q, g) at q ng2 + g, in pairs in 32-bit words
  const int ng2 = (ng + 1) & ~1;
  uint16_t* cw = reinterpret_cast<uint16_t*>(st_x + kStaged * kChunkIds);
  unsigned* cw32 = reinterpret_cast<unsigned*>(cw);
  uint16_t* mine = cw + wi * ng2;
  for (int i = threadIdx.x; i < kPlaceWarps * ng2 / 2; i += blockDim.x)
    cw32[i] = 0;
  __syncthreads();
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kChunkIds;
  const int64_t e1 = min(a.e, e0 + kChunkIds);
  const int64_t w0 = e0 + wi * kWarpIds + lane;
  constexpr int kSteps = kWarpIds / 32;
  int rows[kSteps];
  float vals[kVals ? kSteps : 1][kValsD];
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    rows[it] = id_row<true>(idx, w0 + it * 32, e1, a.n);
    if constexpr (kVals) {
#pragma unroll
      for (int c = 0; c < kValsD; ++c)
        vals[it][c] = w0 + it * 32 < e1 && c < d
                          ? __ldcs(a.val + (w0 + it * 32) * d + c)
                          : 0.f;
    }
  }
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int g = rows[it] < 0 ? -1 : rows[it] >> w.gbits;
    if (g >= 0) {
      const int k = wi * ng2 + g;
      atomicAdd(cw32 + k / 2, 1u << (16 * (k & 1)));
    }
  }
  // where each group's part of this chunk starts in its run, loaded
  // while the ids' loads are in flight
  const int32_t* hp = w.hpre + static_cast<int64_t>(blockIdx.x) * ng;
  for (int g = threadIdx.x; g < ng; g += blockDim.x)
    gbase[g] = w.gstart[g] + hp[g];
  __syncthreads();
  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    int32_t c = 0;
    for (int q = 0; q < kPlaceWarps; ++q) c += cw[q * ng2 + g];
    lstart[g] = c;
  }
  __syncthreads();
  const int32_t kept = block_scan(lstart, lstart, ng, tmp);
  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    int32_t run = lstart[g];
    for (int q = 0; q < kPlaceWarps; ++q) {
      const int32_t c = cw[q * ng2 + g];
      cw[q * ng2 + g] = static_cast<uint16_t>(run);
      run += c;
    }
    gbase[g] -= lstart[g];
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int g = rows[it] < 0 ? -1 : rows[it] >> w.gbits;
    const unsigned peers = match_key(g, w.ng_bits);
    if (g >= 0) {
      const int pos = mine[g] + __popc(peers & lanes_below(lane));
      st_r[pos] = rows[it];
      if constexpr (kVals) {
#pragma unroll
        for (int c = 0; c < kValsD; ++c)
          reinterpret_cast<float*>(st_x)[pos * kValsD + c] = vals[it][c];
      } else {
        st_x[pos] = static_cast<int32_t>(w0 + it * 32);
      }
    }
    __syncwarp();
    if (g >= 0 && lane == __ffs(peers) - 1) mine[g] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // copy out, consecutive threads to consecutive words of the runs
  if constexpr (kVals) {
    for (int j = threadIdx.x; j < kept; j += blockDim.x) {
      const int r = st_r[j];
      const int g = r >> w.gbits;
      const int64_t at = gbase[g] + j;
      w.seg_r[at] = static_cast<uint16_t>(r - (g << w.gbits));
      const float* src = reinterpret_cast<const float*>(st_x) + j * kValsD;
#pragma unroll
      for (int c = 0; c < kValsD; ++c)
        if (c < d) w.seg_v[at * d + c] = src[c];
    }
  } else {
    // or the rows id by id, then the values element by element: consecutive
    // threads take consecutive columns of an id (coalesced loads and
    // stores of its d words), kCopy elements a thread in flight
    for (int j = threadIdx.x; j < kept; j += blockDim.x) {
      const int r = st_r[j];
      const int g = r >> w.gbits;
      w.seg_r[gbase[g] + j] = static_cast<uint16_t>(r - (g << w.gbits));
    }
    const int elems = kept * d;
    for (int q0 = threadIdx.x; q0 < elems; q0 += kCopy * blockDim.x) {
      int64_t at[kCopy];
      float x[kCopy];
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int q = q0 + u * blockDim.x;
        at[u] = -1;
        x[u] = 0.f;
        if (q < elems) {
          const int j = q / d, c = q - j * d;
          const int g = st_r[j] >> w.gbits;
          at[u] = static_cast<int64_t>(gbase[g] + j) * d + c;
          x[u] = __ldcs(a.val + static_cast<int64_t>(st_x[j]) * d + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kCopy; ++u)
        if (at[u] >= 0) w.seg_v[at[u]] = x[u];
    }
  }
}

// Pass 3: one block per group: its ids ranked by row (each warp a
// contiguous part of the group's run, in order), then the rows added as
// the design above says.  Shared memory: the warps' counters (kGroupWarps x
// G ints), the rows' counts and starts (G ints each), then kStageFloats
// values.
template <bool kVals>
__global__ void __launch_bounds__(kGroupThreads)
    group_sum_kernel(const SegmentArgs a, Work w) {
  extern __shared__ int32_t sh[];
  __shared__ int32_t tmp[32];
  const int G = 1 << w.gbits, d = a.d;
  const int lane = threadIdx.x % 32, wi = threadIdx.x / 32;
  int32_t* cw = sh;
  int32_t* cnt = cw + kGroupWarps * G;
  int32_t* start = cnt + G;
  float* vals_s = reinterpret_cast<float*>(start + G);
  int32_t* mine = cw + wi * G;
  const int g = w.order[blockIdx.x], g0 = g << w.gbits;
  const int rows = min(G, a.n - g0);
  const int off = w.gstart[g];
  const int m = w.gstart[g + 1] - off;
  const bool in_smem = kVals && m <= kGroupCap;
  int32_t* gpos = w.slots + off;
  const uint16_t* seg_r = w.seg_r + off;
  const float* v = w.seg_v + static_cast<int64_t>(off) * d;
  for (int i = threadIdx.x; i < kGroupWarps * G; i += blockDim.x) cw[i] = 0;
  __syncthreads();
  // warp wi ranks the part [j0, j1) of the group's run, kWalk steps of 32
  // ids at a time, their rows loaded at once
  const int part = (m + kGroupThreads - 1) / kGroupThreads * 32;
  const int j0 = wi * part, j1 = min(m, j0 + part);
  for (int b = j0; b < j1; b += 32 * kWalk) {
    int rr[kWalk];
#pragma unroll
    for (int k = 0; k < kWalk; ++k) {
      const int j = b + 32 * k + lane;
      rr[k] = j < j1 ? seg_r[j] : -1;
    }
#pragma unroll
    for (int k = 0; k < kWalk; ++k)
      if (rr[k] >= 0) atomicAdd(mine + rr[k], 1);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < G; r += blockDim.x) {
    int32_t c = 0;
    for (int q = 0; q < kGroupWarps; ++q) c += cw[q * G + r];
    cnt[r] = c;
  }
  __syncthreads();
  block_scan(cnt, start, G, tmp);
  for (int r = threadIdx.x; r < G; r += blockDim.x) {
    int32_t run = start[r];
    for (int q = 0; q < kGroupWarps; ++q) {
      const int32_t c = cw[q * G + r];
      cw[q * G + r] = run;
      run += c;
    }
  }
  __syncthreads();
  // the second walk puts each id at its rank: its value into shared
  // memory (in_smem; loaded with its row, coalesced), or its position in
  // the run into global scratch
  constexpr int kVw = kVals ? kWalk : 1;
  for (int b = j0; b < j1; b += 32 * kWalk) {
    int rr[kWalk];
    float vv[kVw][kValsD];
#pragma unroll
    for (int k = 0; k < kWalk; ++k) {
      const int j = b + 32 * k + lane;
      rr[k] = j < j1 ? __ldcs(seg_r + j) : -1;
      if constexpr (kVals) {
#pragma unroll
        for (int c = 0; c < kValsD; ++c)
          vv[k][c] = in_smem && j < j1 && c < d
                         ? __ldcs(v + static_cast<int64_t>(j) * d + c)
                         : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kWalk; ++k) {
      const unsigned peers = match_key(rr[k], w.gbits);
      if (rr[k] >= 0) {
        const int p = mine[rr[k]] + __popc(peers & lanes_below(lane));
        bool staged = false;
        if constexpr (kVals) {
          if (in_smem) {
#pragma unroll
            for (int c = 0; c < kValsD; ++c)
              if (c < d) vals_s[p * d + c] = vv[k][c];
            staged = true;
          }
        }
        if (!staged) gpos[p] = b + 32 * k + lane;
      }
      __syncwarp();
      if (rr[k] >= 0 && lane == __ffs(peers) - 1) mine[rr[k]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  if (in_smem) {
    // thread (r, c): row r's column c, added rank by rank
    for (int t = threadIdx.x; t < rows * d; t += blockDim.x) {
      const int r = t / d, c = t - r * d;
      const float* x = vals_s + start[r] * d + c;
      const int len = cnt[r];
      float acc = 0.f;
#pragma unroll 16
      for (int i = 0; i < len; ++i) acc += x[i * d];
      a.out[static_cast<int64_t>(g0 + r) * d + c] = acc;
    }
    return;
  }
  // the rest (wider rows, or more than kGroupCap ids: hubs of the kNN
  // graph) in passes over the group's ranks, kStageFloats values at a time:
  // a pass's values gathered in rank order by the positions, then each row
  // (column) adds its ranks within the pass to what the earlier passes
  // left in out (kept exactly: a float32 stored and loaded back)
  for (int t = threadIdx.x; t < rows * d; t += blockDim.x)
    if (cnt[t / d] == 0) a.out[static_cast<int64_t>(g0) * d + t] = 0.f;
  const int span = kStageFloats / d;
  for (int base = 0; base < m; base += span) {
    const int n_ids = min(span, m - base);
    // kGather values a thread at once: their positions, then the values,
    // all in flight
    for (int i0 = threadIdx.x; i0 < n_ids * d; i0 += kGather * blockDim.x) {
      int p[kGather];
      float x[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = i0 + u * blockDim.x;
        p[u] = i < n_ids * d ? gpos[base + i / d] : 0;
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = i0 + u * blockDim.x;
        x[u] = i < n_ids * d ? v[static_cast<int64_t>(p[u]) * d + i % d] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n_ids * d) vals_s[i] = x[u];
      }
    }
    __syncthreads();
    // the rows this pass reaches: [r_lo, r_hi), from start (nondecreasing)
    int lo = 0, hi = rows;                 // last row starting <= base
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (start[mid] <= base) lo = mid; else hi = mid;
    }
    const int r_lo = lo;
    lo = r_lo;
    hi = rows;                             // first row starting >= the end
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (start[mid] < base + n_ids) lo = mid + 1; else hi = mid;
    }
    const int r_hi = lo;
    for (int t = threadIdx.x; t < (r_hi - r_lo) * d; t += blockDim.x) {
      const int r = r_lo + t / d, c = t % d;
      const int i0 = max(start[r], base);
      const int i1 = min(start[r] + cnt[r], base + n_ids);
      if (i0 >= i1) continue;
      float* o = a.out + static_cast<int64_t>(g0 + r) * d + c;
      float acc = start[r] < base ? *o : 0.f;
      const float* x = vals_s + (i0 - base) * d + c;
#pragma unroll 16
      for (int i = 0; i < i1 - i0; ++i) acc += x[i * d];
      *o = acc;
    }
    __syncthreads();
  }
}

// Dynamic shared memory beyond 48 KB needs the kernel's leave.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int run_passes(const SegmentArgs& a, const Work& w, cudaStream_t stream) {
  const unsigned nb = static_cast<unsigned>(w.nb);
  const unsigned ng = static_cast<unsigned>(w.ng);
  const size_t ints = sizeof(int32_t);
  const bool vals = a.d <= kValsD;
  const size_t place_smem =
      ints * (2 * w.ng + (vals ? 1 + kValsD : 2) * kChunkIds) +
      sizeof(uint16_t) * kPlaceWarps * ((w.ng + 1) & ~1);
  const size_t group_smem =
      ints * ((kGroupWarps + 2) * (1 << w.gbits)) +
      sizeof(float) * kStageFloats;
  cudaError_t err = vals ? allow_smem(place_kernel<true>, place_smem)
                         : allow_smem(place_kernel<false>, place_smem);
  if (err == cudaSuccess)
    err = vals ? allow_smem(group_sum_kernel<true>, group_smem)
               : allow_smem(group_sum_kernel<false>, group_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // pass 0, count
  if (nb > 0)
    count_kernel<<<nb, kPlaceThreads, ints * w.ng, stream>>>(a.idx, a.e, a.n,
                                                             w);
  // pass 1, scan
  column_scan_kernel<<<(ng + kScanGroups - 1) / kScanGroups,
                       kScanGroups * kSegs, 0, stream>>>(w);
  // heavy: more than 1.5 times the mean group's ids, or past kGroupCap
  int64_t heavy = 3 * a.e / (2 * static_cast<int64_t>(w.ng));
  if (heavy > kGroupCap) heavy = kGroupCap;
  group_scan_kernel<<<1, 1024, 0, stream>>>(w, static_cast<int>(heavy));
  // pass 2, place
  if (nb > 0) {
    if (vals) {
      place_kernel<true><<<nb, kPlaceThreads, place_smem, stream>>>(a, w);
    } else {
      place_kernel<false><<<nb, kPlaceThreads, place_smem, stream>>>(a, w);
    }
  }
  // pass 3, order and sum
  if (vals) {
    group_sum_kernel<true><<<ng, kGroupThreads, group_smem, stream>>>(a, w);
  } else {
    group_sum_kernel<false><<<ng, kGroupThreads, group_smem, stream>>>(a, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_segment_sum(const SegmentArgs* args, cudaStream_t stream) {
  const SegmentArgs& a = *args;
  if (a.d < 1 || a.d > kStageFloats || a.n < 0 || a.e < 0 || a.e >= INT_MAX ||
      group_bits(a.n) > kMaxGroupBits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  return run_passes(a, split_work(a.work, a.n, a.e, a.d), stream);
}
