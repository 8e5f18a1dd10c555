// B8's backward on Hopper's tensor cores: dQ, dK and dV of causal GQA flash
// attention for bf16 q, k, v, out and dout at (D, Dv) = (64, 64), (80, 80),
// (128, 128), (256, 256) and (192, 128), the widths of B8's tensor-core
// forward (flash_attention_wgmma.cu), with wgmma fed by TMA through mbarrier
// rings.  kernels/flash_attention/ops.py (launch_bwd, bwd_route) calls it
// from the backward of models.attention.FlashAttention; float32 and every
// other width take the SIMT backward (flash_attention_bwd.cu).
//
// Replaces: no TPU kernel.  The JAX package's Pallas kernel
//   (src/repro/kernels/flash_attention/kernel.py:86, flash_attention_pallas)
//   is forward only, and the JAX model trains through the jnp scan of
//   repro.models.attention.flash_chunked, whose gradient XLA derives.  It
//   takes B8-bwd's bf16 routes from the SIMT kernel, which ran 14-53x slower
//   than SDPA's backward there.
//
// Computes what the SIMT backward computes (its note gives the formulas):
//   lse recomputed, delta = sum dO o, P = exp(s - lse), dS = P (dP - delta)
//   (times 1 - tanh^2 under a softcap), dV = P^T dO, dK = scale dS^T Q, dQ
//   = scale dS K; causal mask, window, GQA (dK and dV summed over the query
//   heads of a KV head's group), Dv != D, (b, h, s) strides with a unit last
//   stride; gradients rounded to bf16 (RN) once, at the end.  The plain
//   version of this arithmetic is kernels/flash_attention/ref.py,
//   flash_attention_bwd_split_ref.
//
// Bound on the H100: operations.  The backward needs the scores, dP, dV,
//   dQ and dK once each, 2 (3 D + 2 Dv) flops a kept (row, col) pair a query
//   head, at 989 TFLOP/s in bf16.  This design does more: the scores three
//   times (pre, dkdv, dq), dP twice (dkdv, dq), and dV, dK and dQ each as two
//   passes (the split below), 2 (7 D + 4 Dv) a pair, and D more from D = 128
//   on, where two warpgroups share a key tile (the scores once for each):
//   so it can reach at most (3 D + 2 Dv) / (7 D + 4 Dv) of the bound, 45% at
//   D = Dv = 64 and 80, (3 D + 2 Dv) / (8 D + 4 Dv) from 128 on (42% at 128
//   and 256, 41% at (192, 128)).  What the design does about it: every
//   product runs on the tensor cores, every tile arrives by TMA while the
//   one before is computed, scores, P and dS never leave registers, and
//   each kernel's outputs are summed in one CTA's registers.
//
// Design: three kernels on the stream, no atomics.  Every output element is
//   written by one CTA and every sum runs in a fixed order, so a second
//   launch gives the same bits (a train step on the card repeats).  Each
//   kernel: one producer warpgroup, one of whose threads issues every TMA
//   load (setmaxnreg drops it to 24 registers), and one or two consumer
//   warpgroups of 64 rows; tiles of 64 rows x 64 columns (128 bytes), in
//   128-byte swizzle, ceil(W / 64) boxes across a width W; at W = 80 the
//   last 16 columns come in a 64 x 16 box of their own in 32-byte swizzle,
//   so that one layout serves both the K-major use (the k-step over columns
//   64-79) and the MN-major one (an m64n16k16 product over them).  Rows past
//   S are zero-filled by TMA and masked.
//   (i)   pre: one CTA per (64-row query tile, head, batch), two an SM.  Q
//         once, K tiles through a 2-stage ring; S = Q K^T (wgmma, both
//         K-major), scale, softcap and mask as the forward, online max and
//         sum; lse = m + log l; delta a row dot of dO and o read from global
//         memory.  Both go to float32 (B, Hq, S_pad) scratch, S_pad = S
//         rounded up to 64, rows past S as lse = +inf, delta = 0, so that
//         every query tile's row block starts on 256 bytes and can arrive by
//         bulk copy.
//   (ii)  dkdv: one CTA per (64-key tile, KV head, batch), key tile 0 (the
//         most query tiles) first, one an SM.  K and V once by TMA; then,
//         for each query head of the group in order and each query tile
//         that sees the keys (the diagonal one to the last the window
//         reaches), the Q and dO tiles and the rows' lse and delta (two
//         256-byte bulk copies) through a ring.  S^T = K Q^T and dP^T = V
//         dO^T with the keys as wgmma's M, so that the accumulators are laid
//         out as P^T and dS^T, the register A operand of dV += P^T dO and dK
//         += dS^T Q, with dO and Q the MN-major B (the transpose bit).  dK
//         and dV stay in fp32 registers over the whole group.  Two consumer
//         warpgroups: at 64 and 80 they take alternate query tiles (a ring
//         of four stages, two each), each keeping dK and dV, and the first
//         adds the second's sums to its own at the end, through the ring's
//         shared memory; from 128 on, where keeping both spills, they read
//         every query tile (a ring of two), one keeping dK (S^T and dP^T,
//         then dS), the other dV (S^T, then P).
//   (iii) dq: one CTA per 128 query rows (64 at D = 256), head and batch,
//         heaviest first, one an SM; a consumer warpgroup per 64 rows, Q
//         and dO once, K and V tiles through a 2-stage ring shared by both;
//         S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K with K
//         MN-major.
//   A tile's 64 queries (dkdv) or keys (dq) go through the products in one
//   chunk or, where that spilled (dkdv at 80 and (192, 128), dq at
//   (192, 128)), in two of 32 (m64n32k16 for the scores and dP).  dkdv
//   and dq run one CTA an SM, so that ptxas may give a thread 65,536 /
//   threads registers (it reports 168 at 384 threads, 240 at dq's 256 at
//   D = 256), where two CTAs an SM would halve that; pre's consumer fits
//   the 128 of two CTAs an SM.  ptxas's registers and spills of each
//   kernel are in PERF.md.
//   P and dS as register A are each split in two, hi = bf16(x), lo = bf16(x
//   - hi), two wgmma passes into one fp32 accumulator (x to about 2^-16):
//   one bf16 P misses chip_smoke phase (h)'s check in the forward, and one
//   bf16 P and dS miss phase (q1)'s here (tests/test_torch_flash_bwd_wgmma.py
//   shows it on the CPU).  The scores and dP are sums of products of bf16
//   values, exact in fp32 but for the order of the sum.
//   A wait on an mbarrier that has not completed after about 10 s traps.
#include <cuda_bf16.h>

#include "flash_attention_bwd.cuh"
#include "hopper_bf16.cuh"

namespace {

using namespace hopper;

constexpr int kT = 64;                   // rows of a query tile, keys of a key tile
constexpr int kStages = 2;               // tiles in flight
constexpr int kBoxBytes = 64 * 128;      // a box: 64 rows of 128 bytes
constexpr int kTailBytes = 64 * 32;      // a tail box: 64 rows of 16 bf16
constexpr int kStatBytes = kT * 4;       // a query tile's lse (or delta)
constexpr int kProducerRegs = 24;
constexpr int kPreRegs = 232;            // pre's consumer, two CTAs an SM
constexpr int kConsumerRegs = 240;       // dkdv's and dq's, one CTA an SM
constexpr float kNeg = -1e30f;           // the forward's masked score
constexpr float kLog2e = 1.4426950408889634f;

// A 64-row tile W columns wide: W / 64 boxes in 128-byte swizzle and, at
// W % 64 = 16, a 16-column box in 32-byte swizzle.
template <int W>
struct Tile {
  static constexpr int kBoxes = W / 64;
  static constexpr int kTail = W % 64;
  static constexpr int kBytes =
      kBoxes * kBoxBytes + (kTail ? kTailBytes : 0);
  static_assert(W >= 64 && (kTail == 0 || kTail == 16),
                "boxes of 64 columns and one of 16");
};

// The K-major descriptor of k-step ks (16 columns) of a tile at `base`,
// from row r0 (a multiple of 8): 32 bytes into box ks / 4, or the tail box.
template <int W>
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int ks, int r0) {
  return ks < Tile<W>::kBoxes * 4
             ? sw128_desc(base + (ks / 4) * kBoxBytes + r0 * 128 + (ks % 4) * 32,
                          16, 1024)
             : sw32_desc(base + Tile<W>::kBoxes * kBoxBytes + r0 * 32);
}

// acc (64 x N) = A (64 x W) * B (N x W)^T, both K-major: A the tile at a,
// B rows r0 .. r0 + N - 1 of the tile at b.
template <int W, int N>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a,
                                           uint32_t b, int r0) {
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks) {
    if constexpr (N == 64) {
      wgmma_ss_n64(acc, kdesc<W>(a, ks, 0), kdesc<W>(b, ks, r0), ks != 0);
    } else {
      static_assert(N == 32, "N = 32 or 64");
      wgmma_ss_n32(acc, kdesc<W>(a, ks, 0), kdesc<W>(b, ks, r0), ks != 0);
    }
  }
}

// acc (64 x W) += A (64 x 16: k-step kk of a register operand) * rows 16 kk
// .. 16 kk + 15 of a 64 x W tile at `b`, MN-major (the transpose bit): the
// whole boxes by one wgmma at N = 64 W / 64 (128 and 64 at three boxes), the
// tail by one at N = 16.  acc[4 j + e] is column 8 j + ... throughout.
template <int W>
__device__ __forceinline__ void rs_product(float (&acc)[W / 2],
                                           const uint32_t (&a)[4], uint32_t b,
                                           int kk) {
  constexpr int NB = Tile<W>::kBoxes;
  const uint32_t r = b + kk * 16 * 128;
  if constexpr (NB == 1) {
    wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(acc), a,
                 sw128_desc(r, kBoxBytes, 1024), 1);
  } else if constexpr (NB == 2) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(acc), a,
                  sw128_desc(r, kBoxBytes, 1024), 1);
  } else if constexpr (NB == 3) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(acc), a,
                  sw128_desc(r, kBoxBytes, 1024), 1);
    wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(acc + 64), a,
                 sw128_desc(r + 2 * kBoxBytes, kBoxBytes, 1024), 1);
  } else {
    static_assert(NB == 4, "up to four boxes");
    wgmma_rs_n256(*reinterpret_cast<float(*)[128]>(acc), a,
                  sw128_desc(r, kBoxBytes, 1024), 1);
  }
  if constexpr (Tile<W>::kTail != 0)
    wgmma_rs_n16(*reinterpret_cast<float(*)[8]>(acc + NB * 32), a,
                 sw32_desc(b + NB * kBoxBytes + kk * 16 * 32), 1);
}

// x (a 64 x N fp32 accumulator) as the register A operand of N / 16
// k-steps, split in bf16 halves: k-step kk, register r holds x[8 kk + 2 r
// .. + 1].
template <int N>
__device__ __forceinline__ void split_a(const float (&x)[N / 2],
                                        uint32_t (&hi)[N / 16][4],
                                        uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r],
                   lo[kk][r]);
}

template <int W>
__device__ __forceinline__ void zero(float (&x)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = 0.f;
}

// The tensor maps of q, k, v and dO, each with its 16-column tail map (a
// copy of the main one where the width has no tail).
struct Maps {
  CUtensorMap q, qt, k, kt, v, vt, g, gt;
};

// One 64-row tile of width W at row `row` of head h, batch b.
template <int W>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          const CUtensorMap* mt, uint32_t bar,
                                          int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < Tile<W>::kBoxes; ++c)
    tma_load(dst + c * kBoxBytes, m, bar, c * 64, row, h, b);
  if constexpr (Tile<W>::kTail != 0)
    tma_load(dst + Tile<W>::kBoxes * kBoxBytes, mt, bar,
             Tile<W>::kBoxes * 64, row, h, b);
}

// Barriers: one for the tiles loaded once, then a full and an empty one
// per stage of a ring of kS stages.
template <int kS>
struct Bars {
  uint32_t base;
  __device__ uint32_t once() const { return base; }
  __device__ uint32_t full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return base + 8 * (1 + kS + s); }
  static constexpr int kBytes = 8 * (1 + 2 * kS);
};

// `warps`: the consumer warps that arrive on a stage's empty barrier each
// time it is read.
template <int kS>
__device__ __forceinline__ void init_bars(Bars<kS> bars, int warps) {
  if (threadIdx.x == 0) {
    mbar_init(bars.once(), 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(bars.full(s), 1);
      mbar_init(bars.empty(s), warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// One arrival a consumer warp on the stage's empty barrier, once the
// warpgroup's wgmma have read the stage.
template <int kS>
__device__ __forceinline__ void release(Bars<kS> bars, int st) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bars.empty(st));
}

__device__ __forceinline__ int s_pad(const FlashBwdArgs& a) {
  return (a.s + kT - 1) / kT * kT;
}

// The key tiles the `rows` query rows of a CTA see: from the first the
// window reaches to the one holding its last row.
struct Walk {
  int q0, t_begin, n_tiles;
};

__device__ __forceinline__ Walk query_walk(const FlashBwdArgs& a, int rows) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows;   // heaviest first
  const int last_row = min(q0 + rows, a.s) - 1;
  const int t_begin = a.window > 0 ? max(0, q0 - a.window + 1) / kT : 0;
  return {q0, t_begin, last_row / kT - t_begin + 1};
}

// Whether a (query tile q0, key tile c0) pair holds a masked pair: it
// crosses the diagonal, the window's edge or the rows past S.
__device__ __forceinline__ bool edge_tile(const FlashBwdArgs& a, int q0,
                                          int c0) {
  return c0 + kT - 1 > q0 || (a.window > 0 && q0 + kT - 1 - c0 >= a.window) ||
         q0 + kT > a.s;
}

__device__ __forceinline__ bool kept(const FlashBwdArgs& a, int row,
                                     int col) {
  return row < a.s && col <= row && (a.window <= 0 || col > row - a.window);
}

// The scores of a tile in place (scaled, then capped, as the forward),
// each loop behind a branch that is the same for the warpgroup: inside one
// loop the compiler would compute tanhf for every score of every tile.
__device__ __forceinline__ void scores(const FlashBwdArgs& a,
                                       float (&sc)[32]) {
  if (a.softcap > 0.f) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      sc[j] = a.softcap * tanhf(sc[j] * a.scale / a.softcap);
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] *= a.scale;
  }
}

// From a tile's raw products sc and, for dS, its dP, in place: P = exp(s -
// lse) as exp2(s log2e - lse log2e) into sc (kP) and dS = P (dP - delta)
// times the cap's derivative 1 - tanh^2 into dp (kDS).  stat(j, e, lb, dl)
// gives lse log2e and delta of the row of sc[4 j + e].  A row past S has
// lse = +inf: P = 0.
template <bool kCap, bool kP, bool kDS, int N, class Stat>
__device__ __forceinline__ void p_and_ds_capped(const FlashBwdArgs& a,
                                                float (&sc)[N],
                                                float (&dp)[N], Stat stat) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lb, dl, s, dcap = 1.f;
      stat(j, e, lb, dl);
      if constexpr (kCap) {
        const float t = tanhf(sc[4 * j + e] * a.scale / a.softcap);
        s = a.softcap * t;
        dcap = 1.f - t * t;
      } else {
        s = sc[4 * j + e] * a.scale;
      }
      const float p = exp2f(fmaf(s, kLog2e, -lb));
      if constexpr (kP) sc[4 * j + e] = p;
      if constexpr (kDS) dp[4 * j + e] = p * (dp[4 * j + e] - dl) * dcap;
    }
}

template <bool kP, bool kDS, int N, class Stat>
__device__ __forceinline__ void p_and_ds(const FlashBwdArgs& a,
                                         float (&sc)[N], float (&dp)[N],
                                         Stat stat) {
  if (a.softcap > 0.f) {
    p_and_ds_capped<true, kP, kDS>(a, sc, dp, stat);
  } else {
    p_and_ds_capped<false, kP, kDS>(a, sc, dp, stat);
  }
}

template <int W>
__host__ __device__ constexpr int tile_bytes() {
  if constexpr (W == 0) {
    return 0;
  } else {
    return Tile<W>::kBytes;
  }
}

// The producer of pre and dq: NWG tiles of width W0 (and NWG of W1) once,
// for rows q0 + 64 g, then the KV tiles of the walk through the ring.
template <int NWG, int W0, int W1, int KW0, int KW1>
__device__ __forceinline__ void produce_rows(
    const CUtensorMap* m0, const CUtensorMap* m0t, const CUtensorMap* m1,
    const CUtensorMap* m1t, const CUtensorMap* k0, const CUtensorMap* k0t,
    const CUtensorMap* k1, const CUtensorMap* k1t, const FlashBwdArgs& a,
    uint32_t s_once, uint32_t s_ring, Bars<kStages> bars, Walk w) {
  constexpr int kOnce = NWG * (tile_bytes<W0>() + tile_bytes<W1>());
  constexpr int kStage = tile_bytes<KW0>() + tile_bytes<KW1>();
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  mbar_expect_tx(bars.once(), kOnce);
#pragma unroll
  for (int g = 0; g < NWG; ++g) {
    load_tile<W0>(s_once + g * tile_bytes<W0>(), m0, m0t, bars.once(),
                  w.q0 + g * kT, h, bb);
    if constexpr (W1 != 0)
      load_tile<W1>(s_once + NWG * tile_bytes<W0>() + g * tile_bytes<W1>(),
                    m1, m1t, bars.once(), w.q0 + g * kT, h, bb);
  }
  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % kStages;
    const int c0 = (w.t_begin + i) * kT;
    mbar_wait(bars.empty(st), ((i / kStages) & 1) ^ 1);
    mbar_expect_tx(bars.full(st), kStage);
    const uint32_t dst = s_ring + st * kStage;
    load_tile<KW0>(dst, k0, k0t, bars.full(st), c0, hk, bb);
    if constexpr (KW1 != 0)
      load_tile<KW1>(dst + tile_bytes<KW0>(), k1, k1t, bars.full(st), c0, hk,
                     bb);
  }
}

// ---- (i) pre --------------------------------------------------------------

template <int D_>
struct PreCfg {
  static constexpr int D = D_;
  static constexpr int kThreads = 256;
  static constexpr int kSmem = Tile<D>::kBytes * (1 + kStages);
  static constexpr int kSmemAlloc = 1024 + kSmem + Bars<kStages>::kBytes;
};

template <class C>
__device__ __forceinline__ void pre_consume(const FlashBwdArgs& a,
                                            uint32_t sq, uint32_t sk,
                                            Bars<kStages> bars, Walk w) {
  constexpr int D = C::D;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = w.q0 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int colq = (lane % 4) * 2;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  mbar_wait(bars.once(), 0);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % kStages;
    const int c0 = (w.t_begin + i) * kT;
    mbar_wait(bars.full(st), (i / kStages) & 1);
    float sc[32];
    zero(sc);
    fence_regs(sc);
    wgmma_fence();
    ss_product<D, 64>(sc, sq, sk + st * Tile<D>::kBytes, 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    release(bars, st);
    // sc[4 j + e]: row e < 2 ? row0 : row1, column c0 + 8 j + colq + e % 2
    scores(a, sc);
    if (edge_tile(a, w.q0, c0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!kept(a, e < 2 ? row0 : row1, c0 + 8 * j + colq + (e & 1)))
            sc[4 * j + e] = kNeg;
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = m0 > kNeg / 2 ? exp2f((m0 - mn0) * kLog2e) : 0.f;
    const float corr1 = m1 > kNeg / 2 ? exp2f((m1 - mn1) * kLog2e) : 0.f;
    const float mb0 = mn0 > kNeg / 2 ? mn0 * kLog2e : 0.f;
    const float mb1 = mn1 > kNeg / 2 ? mn1 * kLog2e : 0.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum0 += exp2f(fmaf(sc[4 * j], kLog2e, -mb0)) +
              exp2f(fmaf(sc[4 * j + 1], kLog2e, -mb0));
      sum1 += exp2f(fmaf(sc[4 * j + 2], kLog2e, -mb1)) +
              exp2f(fmaf(sc[4 * j + 3], kLog2e, -mb1));
    }
    l0 = corr0 * l0 + quad_sum(sum0);
    l1 = corr1 * l1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
  }

  // delta = sum dO o over Dv: the quad's four lanes take columns 2 (lane %
  // 4) + 8 c, then sum by shuffles
  const int h = blockIdx.y, bb = blockIdx.z;
  const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(a.o) +
                            bb * a.o_st[0] + h * a.o_st[1];
  const __nv_bfloat16* gg = static_cast<const __nv_bfloat16*>(a.g_o) +
                            bb * a.go_st[0] + h * a.go_st[1];
  float d0 = 0.f, d1 = 0.f;
  for (int c = colq; c < a.dv; c += 8) {
    if (row0 < a.s) {
      const float2 o = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(og + row0 * a.o_st[2] + c));
      const float2 g = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(gg + row0 * a.go_st[2] + c));
      d0 += o.x * g.x + o.y * g.y;
    }
    if (row1 < a.s) {
      const float2 o = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(og + row1 * a.o_st[2] + c));
      const float2 g = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(gg + row1 * a.go_st[2] + c));
      d1 += o.x * g.x + o.y * g.y;
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (lane % 4 == 0) {
    const int64_t base = (static_cast<int64_t>(bb) * a.hq + h) * s_pad(a);
    const float inf = __int_as_float(0x7f800000);
    // a row that sees no key (a row past S) gets lse = +inf, so that its P
    // is exp(-inf) = 0
    a.lse[base + row0] = row0 < a.s && l0 > 0.f ? m0 + logf(l0) : inf;
    a.lse[base + row1] = row1 < a.s && l1 > 0.f ? m1 + logf(l1) : inf;
    a.delta[base + row0] = d0;
    a.delta[base + row1] = d1;
  }
}

// Two CTAs an SM: its consumer needs no more than the 128 registers a
// thread starts with.
template <class C>
__global__ void __launch_bounds__(C::kThreads, 2)
    bwd_pre_kernel(const __grid_constant__ Maps m, const FlashBwdArgs a) {
  constexpr int D = C::D;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Tile<D>::kBytes;
  const Bars<kStages> bars{sk + kStages * Tile<D>::kBytes};
  const Walk w = query_walk(a, kT);
  init_bars(bars, 4);
  if (threadIdx.x >= 128) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128)
      produce_rows<1, D, 0, D, 0>(&m.q, &m.qt, nullptr, nullptr, &m.k,
                                  &m.kt, nullptr, nullptr, a, sq, sk, bars,
                                  w);
  } else {
    reg_alloc<kPreRegs>();
    pre_consume<C>(a, sq, sk, bars, w);
  }
}

// ---- (ii) dkdv ------------------------------------------------------------

// Two consumer warpgroups on one 64-key tile.  kSplit (from D = 128 on,
// where dK and dV of 64 keys with the scores leave one warpgroup too few
// registers): both read every query tile, the first keeping dK, the second
// dV, through a ring of two stages.  Else they take alternate query tiles,
// each keeping both, through a ring of four (two each), and add their sums
// at the end, the second's to the first's, through the ring's shared
// memory.
template <int D_, int DV_, bool kSplit_, int kN_>
struct KvCfg {
  static constexpr int D = D_;
  static constexpr int DV = DV_;
  static constexpr bool kSplit = kSplit_;
  static constexpr int kN = kN_;     // queries a chunk: 64, or 32 (two)
  static constexpr int kStages = kSplit ? 2 : 4;
  static constexpr int kStep = kSplit ? 1 : 2;   // a consumer's stride
  static constexpr int kThreads = 3 * 128;
  static constexpr int kKBytes = Tile<D>::kBytes;      // a K or Q tile
  static constexpr int kVBytes = Tile<DV>::kBytes;     // a V or dO tile
  static constexpr int kStage = kKBytes + kVBytes;     // Q and dO
  static constexpr int kSmem =
      kStage * (1 + kStages) + kStages * 2 * kStatBytes;
  static constexpr int kSmemAlloc = 1024 + kSmem + Bars<kStages>::kBytes;
  static_assert(kSplit || kStages * kStage >= kT * (D + DV) * 4,
                "the ring holds a warpgroup's dK and dV");
};

enum Role { kBoth, kDK, kDV };

template <class C>
__device__ __forceinline__ void kv_produce(const Maps& m,
                                          const FlashBwdArgs& a, uint32_t sk,
                                          uint32_t sq, uint32_t ss,
                                          Bars<C::kStages> bars,
                                          int per_head) {
  constexpr int kS = C::kStages;
  const int j0 = blockIdx.x * kT, hk = blockIdx.y, bb = blockIdx.z;
  const int group = a.hq / a.hkv;
  mbar_expect_tx(bars.once(), C::kStage);
  load_tile<C::D>(sk, &m.k, &m.kt, bars.once(), j0, hk, bb);
  load_tile<C::DV>(sk + C::kKBytes, &m.v, &m.vt, bars.once(), j0, hk, bb);
  for (int i = 0; i < group * per_head; ++i) {
    const int st = i % kS;
    const int h = hk * group + i / per_head;
    const int q0 = j0 + (i % per_head) * kT;
    mbar_wait(bars.empty(st), ((i / kS) & 1) ^ 1);
    mbar_expect_tx(bars.full(st), C::kStage + 2 * kStatBytes);
    const uint32_t dst = sq + st * C::kStage;
    load_tile<C::D>(dst, &m.q, &m.qt, bars.full(st), q0, h, bb);
    load_tile<C::DV>(dst + C::kKBytes, &m.g, &m.gt, bars.full(st), q0, h, bb);
    const int64_t row = (static_cast<int64_t>(bb) * a.hq + h) * s_pad(a) + q0;
    bulk_load(ss + st * 2 * kStatBytes, a.lse + row, kStatBytes,
              bars.full(st));
    bulk_load(ss + st * 2 * kStatBytes + kStatBytes, a.delta + row,
              kStatBytes, bars.full(st));
  }
}

// One 64 x W fp32 accumulator from a warpgroup's registers to bf16 rows
// key0, key1 (below S) of a (S, W) slice with row stride st, times mul.
template <int W>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t st,
                                           const float (&acc)[W / 2],
                                           int key0, int key1, int colq,
                                           int s, float mul) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int col = 8 * j + colq;
    if (key0 < s)
      *reinterpret_cast<__nv_bfloat162*>(out + key0 * st + col) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (key1 < s)
      *reinterpret_cast<__nv_bfloat162*>(out + key1 * st + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

template <class C, Role R>
__device__ __forceinline__ void kv_consume(const FlashBwdArgs& a,
                                           const uint8_t* sm, uint32_t sk,
                                           uint32_t sq, uint32_t ss,
                                           Bars<C::kStages> bars,
                                           int per_head, int wg) {
  constexpr int D = C::D, DV = C::DV, kS = C::kStages, kN = C::kN;
  constexpr bool kDoK = R != kDV, kDoV = R != kDK;
  const int j0 = blockIdx.x * kT, hk = blockIdx.y, bb = blockIdx.z;
  const int group = a.hq / a.hkv;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int key0 = j0 + warp * 16 + lane / 4, key1 = key0 + 8;
  const int colq = (lane % 4) * 2;
  const uint32_t sv = sk + C::kKBytes;
  // shared memory by its generic address, for plain loads and stores
  const uint32_t sm0 = smem_u32(sm);
  float dk[kDoK ? D / 2 : 1], dv[kDoV ? DV / 2 : 1];
  zero(dk);
  zero(dv);
  mbar_wait(bars.once(), 0);

  for (int i = C::kSplit ? 0 : wg; i < group * per_head; i += C::kStep) {
    const int st = i % kS;
    const int q0 = j0 + (i % per_head) * kT;
    mbar_wait(bars.full(st), (i / kS) & 1);
    const uint32_t q_base = sq + st * C::kStage;
    const uint32_t g_base = q_base + C::kKBytes;
    const float* lse = reinterpret_cast<const float*>(
        sm + (ss + st * 2 * kStatBytes - sm0));
    const float* dlt = lse + kT;

    const bool edge = edge_tile(a, q0, j0);
    // the tile's queries in chunks of kN (two of 32 where 64 would leave
    // the accumulators too few registers)
#pragma unroll
    for (int hf = 0; hf < kT / kN; ++hf) {
      // S^T = K Q^T and, for dS, dP^T = V dO^T: keys as M, queries as N
      float sc[kN / 2], dp[kN / 2];
      zero(sc);
      fence_regs(sc);
      if constexpr (kDoK) {
        zero(dp);
        fence_regs(dp);
      }
      wgmma_fence();
      ss_product<D, kN>(sc, sk, q_base, kN * hf);
      if constexpr (kDoK) ss_product<DV, kN>(dp, sv, g_base, kN * hf);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if constexpr (kDoK) fence_regs(dp);

      // sc[4 j + e]: key e < 2 ? key0 : key1, query q0 + kN hf + 8 j +
      // colq + e % 2
      const int qh = kN * hf + colq;
      p_and_ds<kDoV, kDoK>(
          a, sc, dp, [&](int j, int e, float& lb, float& dl) {
            const int qc = qh + 8 * j + (e & 1);
            lb = lse[qc] * kLog2e;
            dl = dlt[qc];
          });
      if (edge) {
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!kept(a, q0 + qh + 8 * j + (e & 1), e < 2 ? key0 : key1)) {
              sc[4 * j + e] = 0.f;
              if constexpr (kDoK) dp[4 * j + e] = 0.f;
            }
      }

      // dV += P^T dO, then dK += dS^T Q, over the chunk's k-steps, each as
      // a hi and a lo pass; one group at a time, so that only one split
      // operand is live with the accumulators
      constexpr int kK = kN / 16;
      if constexpr (kDoV) {
        uint32_t hi[kK][4], lo[kK][4];
        split_a<kN>(sc, hi, lo);
        fence_regs(dv);
        fence_regs(hi);
        fence_regs(lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
          rs_product<DV>(dv, hi[kk], g_base, kK * hf + kk);
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
          rs_product<DV>(dv, lo[kk], g_base, kK * hf + kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(hi);
        fence_regs(lo);
      }
      if constexpr (kDoK) {
        uint32_t hi[kK][4], lo[kK][4];
        split_a<kN>(dp, hi, lo);
        fence_regs(dk);
        fence_regs(hi);
        fence_regs(lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
          rs_product<D>(dk, hi[kk], q_base, kK * hf + kk);
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
          rs_product<D>(dk, lo[kk], q_base, kK * hf + kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dk);
        fence_regs(hi);
        fence_regs(lo);
      }
    }
    release(bars, st);
  }

  if constexpr (R == kBoth) {
    // the second warpgroup's sums into the ring (every stage is read by
    // now), then the first adds them to its own: dK = dK_0 + dK_1
    float* part = reinterpret_cast<float*>(const_cast<uint8_t*>(sm) +
                                           (sq - sm0));
    bar_sync_first<256>();
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < D / 2; ++r) part[r * 128 + t] = dk[r];
#pragma unroll
      for (int r = 0; r < DV / 2; ++r) part[(D / 2 + r) * 128 + t] = dv[r];
    }
    bar_sync_first<256>();
    if (wg == 1) return;
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dk[r] += part[r * 128 + t];
#pragma unroll
    for (int r = 0; r < DV / 2; ++r) dv[r] += part[(D / 2 + r) * 128 + t];
  }
  // dK (times scale) and dV to bf16
  if constexpr (kDoK)
    store_rows<D>(static_cast<__nv_bfloat16*>(a.g_k) + bb * a.gk_st[0] +
                      hk * a.gk_st[1],
                  a.gk_st[2], dk, key0, key1, colq, a.s, a.scale);
  if constexpr (kDoV)
    store_rows<DV>(static_cast<__nv_bfloat16*>(a.g_v) + bb * a.gv_st[0] +
                       hk * a.gv_st[1],
                   a.gv_st[2], dv, key0, key1, colq, a.s, 1.f);
}

// One CTA an SM, so that ptxas gives the consumers 168 registers a thread
// (under a bound of two CTAs an SM it would hold them to 80, and they would
// spill).
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    bwd_dkdv_kernel(const __grid_constant__ Maps m, const FlashBwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023) & ~1023u;  // K, then V
  const uint32_t sq = sk + C::kStage;               // per stage: Q, dO
  const uint32_t ss = sq + C::kStages * C::kStage;  // per stage: lse, delta
  const Bars<C::kStages> bars{ss + C::kStages * 2 * kStatBytes};
  // the query tiles that see the key tile: the diagonal one to the last
  // the window reaches
  const int j0 = blockIdx.x * kT;
  const int last_key = min(j0 + kT, a.s) - 1;
  const int last_row =
      a.window > 0 ? min(a.s - 1, last_key + a.window - 1) : a.s - 1;
  const int per_head = last_row / kT - blockIdx.x + 1;
  init_bars(bars, C::kSplit ? 8 : 4);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x % 128 == 0)
      kv_produce<C>(m, a, sk, sq, ss, bars, per_head);
  } else {
    reg_alloc<kConsumerRegs>();
    if constexpr (C::kSplit) {
      if (wg == 0) {
        kv_consume<C, kDK>(a, smem_raw, sk, sq, ss, bars, per_head, wg);
      } else {
        kv_consume<C, kDV>(a, smem_raw, sk, sq, ss, bars, per_head, wg);
      }
    } else {
      kv_consume<C, kBoth>(a, smem_raw, sk, sq, ss, bars, per_head, wg);
    }
  }
}

// ---- (iii) dq -------------------------------------------------------------

// Two consumer warpgroups of 64 query rows each, sharing the KV ring; one
// at D = 256, whose tiles fill shared memory with one.
template <int D_, int DV_, int kN_>
struct QCfg {
  static constexpr int D = D_;
  static constexpr int DV = DV_;
  static constexpr int kN = kN_;     // keys a chunk: 64, or 32 (two)
  static constexpr int NWG = D == 256 ? 1 : 2;
  static constexpr int kThreads = (NWG + 1) * 128;
  static constexpr int kQBytes = Tile<D>::kBytes;     // a Q or K tile
  static constexpr int kGBytes = Tile<DV>::kBytes;    // a dO or V tile
  static constexpr int kStage = kQBytes + kGBytes;
  static constexpr int kSmem = kStage * (NWG + kStages);
  static constexpr int kSmemAlloc = 1024 + kSmem + Bars<kStages>::kBytes;
};

template <class C>
__device__ __forceinline__ void dq_consume(const FlashBwdArgs& a, uint32_t sq,
                                           uint32_t sr, Bars<kStages> bars,
                                           Walk w, int wg) {
  constexpr int D = C::D, DV = C::DV, kN = C::kN, kK = kN / 16;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r_lo = w.q0 + wg * kT;
  const int r_hi = min(r_lo + kT, a.s) - 1;
  const bool has_rows = r_lo < a.s;
  const int row0 = r_lo + warp * 16 + lane / 4, row1 = row0 + 8;
  const int colq = (lane % 4) * 2;
  const int h = blockIdx.y, bb = blockIdx.z;
  float lb0 = 0.f, lb1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  if (has_rows) {          // rows below S_pad
    const int64_t base = (static_cast<int64_t>(bb) * a.hq + h) * s_pad(a);
    lb0 = a.lse[base + row0] * kLog2e;
    lb1 = a.lse[base + row1] * kLog2e;
    dl0 = a.delta[base + row0];
    dl1 = a.delta[base + row1];
  }
  const uint32_t q_base = sq + wg * C::kQBytes;
  const uint32_t g_base = sq + C::NWG * C::kQBytes + wg * C::kGBytes;
  float dq[D / 2];
  zero(dq);
  mbar_wait(bars.once(), 0);

  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % kStages;
    const int c0 = (w.t_begin + i) * kT;
    mbar_wait(bars.full(st), (i / kStages) & 1);
    // whether this warpgroup's rows see any key of the tile: the same for
    // all 128 threads, as wgmma needs
    const bool live = has_rows && c0 <= r_hi &&
                      (a.window <= 0 || c0 + kT - 1 > r_lo - a.window);
    if (live) {
      const uint32_t k_base = sr + st * C::kStage;
      const uint32_t v_base = k_base + C::kQBytes;
      const bool edge = edge_tile(a, r_lo, c0);
      // the tile's keys in chunks of kN, as dkdv's queries
#pragma unroll
      for (int hf = 0; hf < kT / kN; ++hf) {
        float sc[kN / 2], dp[kN / 2];
        zero(sc);
        zero(dp);
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        ss_product<D, kN>(sc, q_base, k_base, kN * hf);     // S = Q K^T
        ss_product<DV, kN>(dp, g_base, v_base, kN * hf);    // dP = dO V^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        // sc[4 j + e]: row e < 2 ? row0 : row1, key c0 + kN hf + 8 j + colq
        // + e % 2
        p_and_ds<false, true>(a, sc, dp,
                              [&](int j, int e, float& lb, float& dl) {
                                lb = e < 2 ? lb0 : lb1;
                                dl = e < 2 ? dl0 : dl1;
                              });
        if (edge) {
          const int kh = c0 + kN * hf + colq;
#pragma unroll
          for (int j = 0; j < kN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!kept(a, e < 2 ? row0 : row1, kh + 8 * j + (e & 1)))
                dp[4 * j + e] = 0.f;
        }

        // dQ += dS K over the chunk's k-steps, K MN-major, as a hi and a
        // lo pass
        uint32_t hi[kK][4], lo[kK][4];
        split_a<kN>(dp, hi, lo);
        fence_regs(dq);
        fence_regs(hi);
        fence_regs(lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
          rs_product<D>(dq, hi[kk], k_base, kK * hf + kk);
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
          rs_product<D>(dq, lo[kk], k_base, kK * hf + kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
        fence_regs(hi);
        fence_regs(lo);
      }
    }
    // waited for all the same, so that every consumer warp arrives once
    // per stage and round
    release(bars, st);
  }
  if (has_rows)
    store_rows<D>(static_cast<__nv_bfloat16*>(a.g_q) + bb * a.gq_st[0] +
                      h * a.gq_st[1],
                  a.gq_st[2], dq, row0, row1, colq, a.s, a.scale);
}

// One CTA an SM, as dkdv (and at D = 256 dQ += dS K is one m64n256k16,
// whose operands alone take 158 registers).
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    bwd_dq_kernel(const __grid_constant__ Maps m, const FlashBwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // Q's, dO's
  const uint32_t sr = sq + C::NWG * C::kStage;   // per stage: K, then V
  const Bars<kStages> bars{sr + kStages * C::kStage};
  const Walk w = query_walk(a, C::NWG * kT);
  init_bars(bars, 4 * C::NWG);
  const int wg = threadIdx.x / 128;
  if (wg == C::NWG) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x % 128 == 0)
      produce_rows<C::NWG, C::D, C::DV, C::D, C::DV>(
          &m.q, &m.qt, &m.g, &m.gt, &m.k, &m.kt, &m.v, &m.vt, a, sq, sr,
          bars, w);
  } else {
    reg_alloc<kConsumerRegs>();
    dq_consume<C>(a, sq, sr, bars, w, wg);
  }
}

// ---- host -----------------------------------------------------------------

// Raise the kernel's dynamic shared-memory limit once, and refuse a build
// whose register count would never let setmaxnreg.inc through: the
// producer's released registers must cover the consumers' rise.
template <class K>
int prepare(K kernel, int smem, int consumers, int consumer_regs,
            int& regs) {
  if (regs == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    regs = attr.numRegs;
  }
  if (regs - kProducerRegs < consumers * (consumer_regs - regs))
    return repro::kErrRegisterPool;
  return 0;
}

// The main and tail maps of one (B, H, S, W) view.
int map_pair(CUtensorMap* m, CUtensorMap* mt, const void* ptr,
             const int64_t st[3], int w, int s, int h, int b) {
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = make_map(m, ptr, st, w, s, h, b, kBf16, 2, 64);
  *mt = *m;                               // read only where w % 64 != 0
  if (!err && w % 64 != 0)
    err = make_map(mt, ptr, st, w, s, h, b, kBf16, 2, 64, 32);
  return err;
}

// kSplit, kKvN: KvCfg's; kQN: QCfg's kN.
template <int D, int DV, bool kSplit, int kKvN, int kQN>
int launch(const FlashBwdArgs& a, cudaStream_t stream) {
  using P = PreCfg<D>;
  using KV = KvCfg<D, DV, kSplit, kKvN>;
  using Q = QCfg<D, DV, kQN>;
  static int regs_pre = 0, regs_kv = 0, regs_q = 0;
  int err = prepare(bwd_pre_kernel<P>, P::kSmemAlloc, 1, kPreRegs, regs_pre);
  if (!err)
    err = prepare(bwd_dkdv_kernel<KV>, KV::kSmemAlloc, 2, kConsumerRegs,
                  regs_kv);
  if (!err)
    err = prepare(bwd_dq_kernel<Q>, Q::kSmemAlloc, Q::NWG, kConsumerRegs,
                  regs_q);
  Maps m;
  if (!err) err = map_pair(&m.q, &m.qt, a.q, a.q_st, D, a.s, a.hq, a.b);
  if (!err) err = map_pair(&m.k, &m.kt, a.k, a.k_st, D, a.s, a.hkv, a.b);
  if (!err) err = map_pair(&m.v, &m.vt, a.v, a.v_st, DV, a.s, a.hkv, a.b);
  if (!err) err = map_pair(&m.g, &m.gt, a.g_o, a.go_st, DV, a.s, a.hq, a.b);
  if (err) return err;
  const int tiles = (a.s + kT - 1) / kT;
  bwd_pre_kernel<P><<<dim3(tiles, a.hq, a.b), P::kThreads, P::kSmemAlloc,
                      stream>>>(m, a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  bwd_dkdv_kernel<KV><<<dim3(tiles, a.hkv, a.b), KV::kThreads,
                        KV::kSmemAlloc, stream>>>(m, a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int q_tiles = (a.s + Q::NWG * kT - 1) / (Q::NWG * kT);
  bwd_dq_kernel<Q><<<dim3(q_tiles, a.hq, a.b), Q::kThreads, Q::kSmemAlloc,
                     stream>>>(m, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention_bwd_wgmma(const FlashBwdArgs* args,
                                               cudaStream_t stream) {
  const FlashBwdArgs& a = *args;
  if (!a.bf16 || a.hkv < 1 || a.hq % a.hkv || a.b < 1 || a.hq < 1 ||
      a.b > 65535 || a.hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.s < 1) return 0;
  // each width's dkdv form and chunks: the fastest of those tried on the
  // H100 (scripts/b8_bwd_ab.py's split by kernel; the two warpgroups
  // alternate at 64 and 80, split dK from dV from 128 on, where keeping
  // both spills); ref.py's BWD_WGMMA_PLAN mirrors this table
  if (a.d == 64 && a.dv == 64) return launch<64, 64, false, 64, 64>(a, stream);
  if (a.d == 80 && a.dv == 80) return launch<80, 80, false, 32, 64>(a, stream);
  if (a.d == 128 && a.dv == 128)
    return launch<128, 128, true, 64, 64>(a, stream);
  if (a.d == 192 && a.dv == 128)
    return launch<192, 128, true, 32, 32>(a, stream);
  if (a.d == 256 && a.dv == 256)
    return launch<256, 256, true, 64, 64>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
