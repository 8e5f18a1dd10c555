// B8 on Hopper's tensor cores: causal GQA flash attention for bf16 q, k, v
// and out at (D, Dv) = (64, 64), (80, 80), (128, 128), (256, 256) and
// (192, 128), with wgmma fed by TMA through an mbarrier ring.  D is the
// width of q and k, Dv that of v and out.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:86,
//   flash_attention_pallas (body _flash_kernel), for bf16 at those widths:
//   the heads of MusicGen-large (64), Zamba2-2.7B's shared attention
//   block (80), Qwen2-7B (128) and Gemma2-2b (256), and DeepSeek-V2's MLA
//   prefill (q and k of 128 + 64, v of 128: the contract of
//   repro.models.attention.flash_chunked, "Dv may differ from D", which
//   the Pallas kernel itself does not take).  The SIMT kernel
//   (flash_attention.cu) keeps float32 and the other widths;
//   kernels/flash_attention/ops.py chooses by dtype, D and Dv.
//   It computes what the SIMT kernel computes (causal mask, optional
//   window and softcap, GQA, fp32 online softmax, a fully masked row gives
//   0, output rounded to bf16), through the same (b, h, s) strides.
//
// Bound on the H100: operations.  Causal attention does 2 B Hq (D + Dv)
//   pairs flops (QK^T and PV over the (row, col) pairs the mask keeps), at
//   989 TFLOP/s in bf16: MusicGen's prefill shape (B 4, S 1500, 32 heads of 64)
//   is 36.9 GFLOP, 0.037 ms, against 0.015 ms for the bytes of q, k, v and
//   out; Zamba2-2.7B's prefill (B 2, S 2048, 32 heads of 80) is 43.0
//   GFLOP, 0.043 ms.  What the design does about it: every product runs
//   on the tensor cores (wgmma), the next K and V tiles arrive by TMA
//   while the current one is computed, and scores and probabilities never
//   leave registers.  Two costs stay above the bound: P.V runs twice (the
//   split below), 1.5x the tensor-core work of one pass; and the softmax's
//   exp, max and sum per score run on the SM's FP32 and MUFU units, which
//   at D = 64 take longer than the tile's wgmma (no ping-pong of two
//   warpgroups here).
//
// Design (TMA, wgmma, an mbarrier pipeline, warp specialisation):
//   * Grid: one CTA per (query tile, head, batch), the query tiles with the
//     most KV tiles launched first.  A query tile is 64 rows per consumer
//     warpgroup: one consumer warpgroup at D = 64, 80, 128 and (192, 128)
//     (two CTAs per SM), two at D = 256 (one CTA per SM: its tiles fill
//     shared memory).  One more warpgroup is the producer: one of its
//     threads issues every TMA load; setmaxnreg drops it to 24 registers
//     and raises the consumers to 232 (240 with two consumer warpgroups).
//   * Loads: the Q tile once, then K and V tiles of kBK = 64 keys through a
//     ring of kStages = 2 stages (a K tile D wide, a V tile Dv wide, each
//     through a tensor map of its own width).  Each stage has a full mbarrier for K and
//     one for V, which TMA completes on the stage's byte count, and an empty
//     mbarrier on which each consumer warp arrives once its warpgroup's
//     wgmma have read the stage.  A tile is one box of 64 rows x 64 columns (128 bytes)
//     per 64 columns of D, ceil(D / 64) boxes, in 128-byte swizzle: the
//     layout the wgmma descriptors name.  Where D is no multiple of 64 the
//     last box overhangs the row: the tensor map has the real width, so
//     TMA fills the box's columns past D with zeros (as it fills rows past
//     S), and the stage's byte count is still the whole boxes'.  At D = 80
//     that is columns 80-127 of Q's and K's second box.  A V tile is
//     Dv / 64 such boxes and, where Dv % 64 = 16 (Dv = 80), its last 16
//     columns in a box of 64 rows x 32 bytes of their own, in 32-byte
//     swizzle, through a tensor map of its own.  Shared memory: Q 8 KB x
//     ceil(D / 64) per consumer warpgroup, K 8 KB x ceil(D / 64) and V 8 KB
//     x (Dv / 64), plus 2 KB for a tail, per stage: 40 KB at D = 64, 68 KB
//     at 80, 80 KB at 128, 192 KB at 256, 104 KB at (192, 128), plus 1 KB
//     of alignment and the barriers.
//   * Tensor maps: 4-D over the strided view (D, S, H, B), encoded on the
//     host with cuTensorMapEncodeTiled.  The library gets that driver
//     function at run time through cudaGetDriverEntryPoint(ByVersion), so
//     it does not link libcuda.  They reach the kernel as
//     __grid_constant__ CUtensorMap.  TMA zero-fills rows past S, and the
//     ragged last tile is masked as in the SIMT kernel.  TMA needs 16-byte
//     strides and base addresses: the wrapper raises on others.
//   * S = Q K^T: wgmma m64n64k16, bf16 x bf16 -> fp32, A and B both from
//     shared memory and both K-major, over D / 16 k-steps (five at D = 80,
//     so the zero columns of an overhanging box are never multiplied).  The
//     products of bf16 values are exact in fp32; only the order of the sum
//     differs from the plain version.
//   * Softmax in registers, in the accumulator's layout (a thread holds rows
//     r and r + 8 of its warp's 16, two adjacent columns of every 8):
//     scale, softcap, then the mask, only on the tiles that cross the
//     diagonal or the window's edge.  Tiles wholly above the diagonal or
//     outside the window are not computed.  Row max and sum by shuffles
//     within the quad that holds a row; exp(x - max) as one FFMA and one
//     ex2; fp32 running max and denominator, the latter summed from fp32 p.
//   * O += P V with P split in two: p_hi = bf16(p), p_lo = bf16(p - p_hi),
//     two register-A wgmma passes against the same V tile (B MN-major,
//     through the instruction's transpose bit) into one fp32 accumulator:
//     each k-step one m64nNk16 at N = 64 (Dv / 64) over V's whole boxes
//     and, at Dv = 80, one m64n16k16 over the tail box (a 32-byte-swizzled
//     descriptor), so no product reaches past Dv.  The other form, P.V at
//     N = 128 over two boxes of 64 whose second overhangs (zero columns
//     80-127), took 1.08x this one's time at Zamba2-2.7B's shape on the
//     H100 (scripts/b8_d80_ab.py).  p_hi + p_lo carries p to about 2^-16
//     relative.  One bf16 P (2^-9) fails chip_smoke phase (h)'s check
//     against the plain version, which keeps p in fp32, in 8% of the
//     outputs at MusicGen's prefill shape.
//   * Epilogue: O / max(l, 1e-30), rounded to bf16 (RN), stored through the
//     out strides.
//   * A wait on an mbarrier that has not completed after 2^34 cycles (about
//     10 s) traps, so a fault in the pipeline ends the launch with an error
//     instead of hanging the card.
#include <cuda_bf16.h>

#include "flash_attention.cuh"
#include "hopper_bf16.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;                  // keys per KV tile
constexpr int kStages = 2;               // KV tiles in flight
constexpr int kBox = 64;                 // rows and columns of a TMA box
constexpr int kBoxBytes = kBox * 128;    // 64 rows of 128 bytes
constexpr int kTailBytes = kBox * 32;    // 64 rows of 16 bf16 (V's tail)
constexpr int kProducerRegs = 24;
constexpr float kNeg = -1e30f;           // the JAX kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// One instantiation: the q / k width, the v / out width and the consumer
// warpgroups, from which the CTAs per SM (the launch bound) and the
// consumers' registers follow.
template <int D_, int DV_, int NWG_>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int DV = DV_;
  static constexpr int NWG = NWG_;
  static constexpr int kMinBlocks = NWG == 1 ? 2 : 1;
  static constexpr int kConsumerRegs = NWG == 1 ? 232 : 240;
  // boxes of 64 columns across D; at D % 64 != 0 the last box overhangs
  // the row, and TMA fills its columns past D with zeros
  static constexpr int kBlocks = (D + 63) / 64;
  static constexpr int kKSteps = D / 16;           // k-steps of S = Q K^T
  // V: Dv / 64 boxes of 64 columns, then Dv % 64 (0 or 16) columns in a
  // 32-byte-swizzled box of their own
  static constexpr int kVBlocks = DV / 64;
  static constexpr int kVTail = DV % 64;
  static constexpr int kTileBytes = kBlocks * kBoxBytes;    // a Q or K tile
  static constexpr int kVTileBytes =
      kVBlocks * kBoxBytes + (kVTail ? kTailBytes : 0);     // a V tile
  static constexpr int kQBytes = NWG * kTileBytes;
  static constexpr int kBars = 1 + 3 * kStages;    // q; k_full, v_full, empty
  static constexpr int kSmem = kQBytes + kStages * (kTileBytes + kVTileBytes);
  static constexpr int kSmemAlloc = 1024 + kSmem + 8 * kBars;
  static constexpr int kThreads = (NWG + 1) * 128;
  static_assert(D % 16 == 0 && DV >= 64 && (kVTail == 0 || kVTail == 16),
                "k-steps of 16; V in boxes of 64 and one of 16 columns");
};

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DV == 64) {
    wgmma_rs_n64(o, a, db, 1);
  } else if constexpr (DV == 128) {
    wgmma_rs_n128(o, a, db, 1);
  } else {
    wgmma_rs_n256(o, a, db, 1);
  }
}

// O (64 x Dv) += A (one k-step of P, 16 keys) * V: the V tile's whole
// boxes by one wgmma at N = 64 (Dv / 64), its 16-column tail, if any, by
// one at N = 16.  o's fragments of the two products follow each other in
// the accumulator's layout, so o[4 j + e] is column 8 j + ... throughout.
template <class C>
__device__ __forceinline__ void wgmma_pv_step(float (&o)[C::DV / 2],
                                              const uint32_t (&a)[4],
                                              uint32_t v_base, int kk) {
  constexpr int NM = C::kVBlocks * 64;
  wgmma_pv<NM>(*reinterpret_cast<float(*)[NM / 2]>(o), a,
               sw128_desc(v_base + kk * 16 * 128, kBoxBytes, 1024));
  if constexpr (C::kVTail != 0)
    wgmma_rs_n16(*reinterpret_cast<float(*)[8]>(o + NM / 2), a,
                 sw32_desc(v_base + C::kVBlocks * kBoxBytes + kk * 16 * 32),
                 1);
}

struct Bars {
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const {
    return base + 8 * (1 + kStages + s);
  }
  __device__ uint32_t empty(int s) const {
    return base + 8 * (1 + 2 * kStages + s);
  }
};

// The tiles one CTA walks: from the first the window reaches to the one
// holding its last row.
struct Walk {
  int q0;        // the CTA's first query row
  int t_begin;   // its first KV tile
  int n_tiles;
};

__device__ __forceinline__ Walk walk(const FlashArgs& a, int rows) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows;   // heaviest first
  const int last_row = min(q0 + rows, a.s) - 1;
  const int t_begin = a.window > 0 ? max(0, q0 - a.window + 1) / kBK : 0;
  return {q0, t_begin, last_row / kBK - t_begin + 1};
}

// The producer: one thread loads Q, then streams the K and V tiles.
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const CUtensorMap* tvt,
                                        const FlashArgs& a, uint32_t sq,
                                        uint32_t sk, uint32_t sv, Bars bars,
                                        Walk w) {
  constexpr int NWG = C::NWG;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  mbar_expect_tx(bars.q(), C::kQBytes);
#pragma unroll
  for (int g = 0; g < NWG; ++g)
#pragma unroll
    for (int c = 0; c < C::kBlocks; ++c)
      tma_load(sq + (g * C::kBlocks + c) * kBoxBytes, tq, bars.q(), c * kBox,
               w.q0 + g * 64, h, bb);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int c0 = (w.t_begin + i) * kBK;
    mbar_wait(bars.empty(st), parity ^ 1);
    mbar_expect_tx(bars.k_full(st), C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::kBlocks; ++c)
      tma_load(sk + st * C::kTileBytes + c * kBoxBytes, tk, bars.k_full(st),
               c * kBox, c0, hk, bb);
    mbar_expect_tx(bars.v_full(st), C::kVTileBytes);
#pragma unroll
    for (int c = 0; c < C::kVBlocks; ++c)
      tma_load(sv + st * C::kVTileBytes + c * kBoxBytes, tv, bars.v_full(st),
               c * kBox, c0, hk, bb);
    if constexpr (C::kVTail != 0)
      tma_load(sv + st * C::kVTileBytes + C::kVBlocks * kBoxBytes, tvt,
               bars.v_full(st), C::kVBlocks * kBox, c0, hk, bb);
  }
}

// A consumer warpgroup: 64 query rows through every tile of the walk.
template <class C>
__device__ __forceinline__ void consume(const FlashArgs& a, uint32_t sq,
                                        uint32_t sk, uint32_t sv, Bars bars,
                                        Walk w, int wg) {
  constexpr int DV = C::DV;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int r_lo = w.q0 + wg * 64;
  const int r_hi = min(r_lo + 63, a.s - 1);
  const bool has_rows = r_lo < a.s;
  const int row0 = r_lo + warp * 16 + lane / 4;   // and row0 + 8
  const int row1 = row0 + 8;
  const int colq = (lane % 4) * 2;    // the thread's first column of each 8
  const uint32_t q_base = sq + wg * C::kTileBytes;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  mbar_wait(bars.q(), 0);

  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int c0 = (w.t_begin + i) * kBK;
    mbar_wait(bars.k_full(st), parity);
    // whether any (row, col) of this warpgroup's rows and this tile is
    // kept: the same for all 128 threads, as wgmma needs
    const bool live = has_rows && c0 <= r_hi &&
                      (a.window <= 0 || c0 + kBK - 1 > r_lo - a.window);
    if (live) {
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      const uint32_t k_base = sk + st * C::kTileBytes;
      fence_regs(sc);
      wgmma_fence();
      // k-step ks: 16 columns, 32 bytes into box ks / 4; none reaches
      // the zero columns of an overhanging box
#pragma unroll
      for (int ks = 0; ks < C::kKSteps; ++ks) {
        const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
        wgmma_ss_n64(sc, sw128_desc(q_base + off, 16, 1024),
                     sw128_desc(k_base + off, 16, 1024), ks != 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // sc[4 j + e]: row e < 2 ? row0 : row1, column c0 + 8 j + colq + e % 2
      // scale and softcap, then the mask, each a loop of its own behind a
      // branch that is the same for the warpgroup: inside one loop the
      // compiler turns both branches into selects and computes tanhf for
      // every score of every tile
      if (a.softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < 32; ++j)
          sc[j] = a.softcap * tanhf(sc[j] * a.scale / a.softcap);
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] *= a.scale;
      }
      if (c0 + kBK - 1 > r_lo || (a.window > 0 && c0 <= r_hi - a.window)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? row0 : row1;
            const int col = c0 + 8 * j + colq + (e & 1);
            const bool ok = col <= row &&
                            (a.window <= 0 || col > row - a.window);
            if (!ok) sc[4 * j + e] = kNeg;
          }
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
      // p = exp(x - max) as exp2(x log2e - max log2e): one FFMA and one
      // ex2 a score.  A row with nothing kept yet (max = kNeg) subtracts 0,
      // so that its kNeg scores give exp2(-1.4e30) = 0, as masked ones do
      // in a live row
      const float mb0 = mn0 > kNeg / 2 ? mn0 * kLog2e : 0.f;
      const float mb1 = mn1 > kNeg / 2 ? mn1 * kLog2e : 0.f;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              exp2f(fmaf(sc[4 * j + e], kLog2e, -(e < 2 ? mb0 : mb1)));
          sc[4 * j + e] = p;
          if (e < 2) {
            sum0 += p;
          } else {
            sum1 += p;
          }
        }
      l0 = corr0 * l0 + quad_sum(sum0);
      l1 = corr1 * l1 + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;

      // A fragment of k-step kk, register r: sc[8 kk + 2 r], sc[8 kk + 2 r + 1]
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1],
                       p_hi[kk][r], p_lo[kk][r]);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }

      mbar_wait(bars.v_full(st), parity);
      const uint32_t v_base = sv + st * C::kVTileBytes;
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_pv_step<C>(o, p_hi[kk], v_base, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_pv_step<C>(o, p_lo[kk], v_base, kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
    } else {
      // not computed; waited for all the same, so that every consumer
      // thread arrives once per stage and round and no load is in flight
      // when the stage is refilled or the CTA exits
      mbar_wait(bars.v_full(st), parity);
    }
    // one arrival a warp, once the warp is past the wait that ends the
    // warpgroup's reads of the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.empty(st));
  }

  if (!has_rows) return;
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) +
                      blockIdx.z * a.o_st[0] + blockIdx.y * a.o_st[1];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = 8 * j + colq;
    if (row0 < a.s)
      *reinterpret_cast<__nv_bfloat162*>(og + row0 * a.o_st[2] + col) =
          __floats2bfloat162_rn(o[4 * j] / den0, o[4 * j + 1] / den0);
    if (row1 < a.s)
      *reinterpret_cast<__nv_bfloat162*>(og + row1 * a.o_st[2] + col) =
          __floats2bfloat162_rn(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tvt,
                       const FlashArgs a) {
  constexpr int NWG = C::NWG;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + C::kQBytes;
  const uint32_t sv = sk + kStages * C::kTileBytes;
  const Bars bars{sv + kStages * C::kVTileBytes};
  const Walk w = walk(a, 64 * NWG);

  if (threadIdx.x == 0) {
    mbar_init(bars.q(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.empty(s), NWG * 4);      // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if-else for the two roles, never reconverging (setmaxnreg)
  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x % 128 == 0)
      produce<C>(&tq, &tk, &tv, &tvt, a, sq, sk, sv, bars, w);
  } else {
    reg_alloc<C::kConsumerRegs>();
    consume<C>(a, sq, sk, sv, bars, w, wg);
  }
}

// ---- host ---------------------------------------------------------------

template <class C>
int launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr int D = C::D, DV = C::DV, NWG = C::NWG;
  auto kernel = flash_wgmma_kernel<C>;
  // setmaxnreg.inc waits until the producer's released registers cover it:
  // refuse to launch a build whose register count would never let it
  static int regs = 0;
  if (regs == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    regs = attr.numRegs;
  }
  if (regs - kProducerRegs < NWG * (C::kConsumerRegs - regs))
    return repro::kErrRegisterPool;
  CUtensorMap tq, tk, tv, tvt;
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = make_map(&tq, a.q, a.q_st, D, a.s, a.hq, a.b, kBf16, 2, kBox);
  if (!err)
    err = make_map(&tk, a.k, a.k_st, D, a.s, a.hkv, a.b, kBf16, 2, kBox);
  if (!err)
    err = make_map(&tv, a.v, a.v_st, DV, a.s, a.hkv, a.b, kBf16, 2, kBox);
  tvt = tv;                               // read only where Dv % 64 != 0
  if (!err && C::kVTail != 0)
    err = make_map(&tvt, a.v, a.v_st, DV, a.s, a.hkv, a.b, kBf16, 2, kBox,
                   C::kVTail * 2);
  if (err) return err;
  const dim3 grid((a.s + 64 * NWG - 1) / (64 * NWG), a.hq, a.b);
  kernel<<<grid, C::kThreads, C::kSmemAlloc, stream>>>(tq, tk, tv, tvt, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention_wgmma(const FlashArgs* args,
                                           cudaStream_t stream) {
  const FlashArgs& a = *args;
  if (!a.bf16 || a.hkv < 1 || a.hq % a.hkv || a.b < 1 || a.hq < 1 ||
      a.b > 65535 || a.hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.s < 1) return 0;
  if (a.d == 64 && a.dv == 64) return launch<Cfg<64, 64, 1>>(a, stream);
  if (a.d == 128 && a.dv == 128) return launch<Cfg<128, 128, 1>>(a, stream);
  if (a.d == 256 && a.dv == 256) return launch<Cfg<256, 256, 2>>(a, stream);
  if (a.d == 192 && a.dv == 128) return launch<Cfg<192, 128, 1>>(a, stream);
  if (a.d == 80 && a.dv == 80) return launch<Cfg<80, 80, 1>>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
