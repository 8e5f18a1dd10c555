// B8 on Hopper's tensor cores for float32: causal GQA flash attention for
// float32 q, k, v and out at D = Dv = 64 and 128, in three TF32 products per
// matrix product (3xTF32, "fast fp32"), with wgmma fed by TMA through an
// mbarrier ring.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:86,
//   flash_attention_pallas (body _flash_kernel), for float32 at those D:
//   MusicGen-large's heads (64) when the model computes in float32 (every
//   smoke_variant config does), and Qwen2-7B's width (128).  The bf16
//   kernel (flash_attention_wgmma.cu) keeps bf16; the SIMT kernel
//   (flash_attention.cu) keeps the other float32 and bf16 widths (a Dv
//   other than D among them); kernels/flash_attention/ops.py chooses by
//   dtype, D and Dv.  It computes
//   what the others compute (causal mask, optional window and softcap,
//   GQA, fp32 online softmax, a fully masked row gives 0) through the same
//   (b, h, s) strides, to float32's accuracy.
//
// Bound on the H100: operations.  Causal attention does 4 B Hq D pairs
//   flops; for fp32 accuracy on the tensor cores each product is three
//   TF32 products, at 494.7 TFLOP/s dense: 3 x 36.9 GFLOP at MusicGen's
//   prefill shape (B 4, S 1500, 32 heads of 64) is 0.224 ms, against 0.551
//   ms for one pass at the 67 TFLOP/s of fp32 FMA (the SIMT kernel's
//   bound) and 0.029 ms for the bytes of q, k, v and out.
//
// What the PTX ISA gives for TF32 (and what the design does about it):
//   * wgmma .tf32 is m64nNk8 (8 tf32 = 32 bytes of depth, as bf16's k16);
//     A comes from shared memory (a descriptor) or from registers (four
//     .b32 a thread), B from shared memory.  The transpose immediates exist
//     only for .f16/.bf16: both shared-memory operands must be K-major.
//     Q and K are K-major as TMA loads them (D contiguous).  V is not: it
//     is transposed by the consumers into a K-major tile, V^T (D rows of
//     the tile's keys), after its TMA load.
//   * A in registers has, per warp, the layout of mma.m16n8k8.tf32: a0 =
//     (row g, k t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4),
//     with g = lane / 4, t = lane % 4.  The scores' accumulator gives a
//     thread columns 2t and 2t + 1 of each 8, so P is used where it lies:
//     k = t is key 2t and k = t + 4 is key 2t + 1 of each group of 8, and
//     V^T's 8 positions of a group hold keys 0, 2, 4, 6, 1, 3, 5, 7 (the
//     sum over k is the same sum in another order).
//   * How the tensor core treats the low 13 bits of an fp32 operand
//     (truncate or round) does not enter: every operand is made an exact
//     tf32 value first.  x = hi + lo with hi = rna_tf32(x) and lo =
//     rna_tf32(x - hi), where rna_tf32 rounds to 10 fraction bits, to
//     nearest with ties away from zero (cvt's .rna), by integer arithmetic
//     on the bits: (u + 0x1000) & ~0x1fff.
//     Products of tf32 values are exact in fp32.
//
// Design:
//   * x.y ~ hi.hi' + hi.lo' + lo.hi' (the lo.lo' term, 2^-22 relative, is
//     dropped), each a wgmma into one fp32 accumulator, smaller terms first.
//     One TF32 pass (2^-11) fails chip_smoke phase (h)'s check against the
//     plain version (1e-5 of the largest |out|); so does dropping either
//     cross term (tests/test_torch_flash_tf32.py, on the CPU).
//   * Grid and roles as the bf16 kernel: one CTA per (query tile, head,
//     batch), heaviest first; NWG consumer warpgroups of 64 query rows and
//     one producer warp whose lane 0 issues every TMA load.  D = 64: two
//     consumer warpgroups and 64-key tiles; D = 128: one, and 32-key tiles.
//     One CTA per SM (176 KB of shared memory), no setmaxnreg.
//   * Shared memory, every tile in boxes of 32 floats (128 bytes) by rows,
//     128-byte swizzle: Q hi and lo of each warpgroup; a ring of two stages
//     of raw K and raw V tiles (TMA's targets); one K lo tile, one V^T hi
//     and one V^T lo tile.
//   * Per KV tile, all consumers together: K split in place (hi over the
//     raw tile, lo beside it), proxy fence, named barrier; each warpgroup
//     whose rows the tile reaches: S = Q K^T (3 x D/8 wgmma m64nBKk8, A and
//     B from shared memory), then the bf16 kernel's softmax in registers
//     (scale, softcap, mask behind uniform branches; fp32 running max and
//     sum; exp as FFMA + ex2).  Then V split and transposed into V^T hi and
//     lo, proxy fence, barrier, and O += P V as 3 x BK/8 wgmma m64nDk8
//     with P's hi and lo parts as register A.  A stage is released to the
//     producer by one arrival per consumer warp.
//   * Epilogue: O / max(l, 1e-30), stored as float2 through the out strides.
//   * Every mbarrier wait traps after about 10 s (hopper.cuh).
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 2;               // K and V tiles in flight
constexpr int kRow = 128;                // bytes of a swizzled row: 32 floats
constexpr int kQRows = 64;               // query rows of a consumer warpgroup
constexpr int kQBox = kQRows * kRow;     // one 32-column box of a Q tile
constexpr float kNeg = -1e30f;           // the JAX kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// One instantiation: head width, keys per KV tile, consumer warpgroups.
template <int D_, int BK_, int NWG_>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int BK = BK_;
  static constexpr int NWG = NWG_;
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32;       // + a producer warp
  static constexpr int kQBytes = (D / 32) * kQBox;       // a warpgroup's Q
  static constexpr int kKVBox = BK * kRow;               // 32 columns of K, V
  static constexpr int kTileBytes = (D / 32) * kKVBox;   // a K or V tile
  static constexpr int kVtBox = D * kRow;                // 32 keys of V^T
  static constexpr int kQhi = 0;
  static constexpr int kQlo = NWG * kQBytes;
  static constexpr int kK = 2 * NWG * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kKlo = kV + kStages * kTileBytes;
  static constexpr int kVthi = kKlo + kTileBytes;
  static constexpr int kVtlo = kVthi + kTileBytes;
  static constexpr int kBarOff = kVtlo + kTileBytes;
  static constexpr int kBars = 1 + 3 * kStages;    // q; k_full, v_full, empty
  static constexpr int kSmemAlloc = 1024 + kBarOff + 8 * kBars;
  static_assert(D * BK / 4 % kConsumers == 0, "V^T items per thread");
  static_assert(kTileBytes / 16 % kConsumers == 0, "K float4s per thread");
};

// ---- wgmma: each shape with its accumulator registers written out ----
// D (64 x N, fp32) (+)= A (64 x 8 tf32) * B (N x 8 tf32, smem, K-major);
// A from shared memory (ss, K-major) or from registers (rs); scale_d = 0
// overwrites D.

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16],
    uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
    uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 32) {
    wgmma_ss_n32(d, da, db, scale_d);
  } else {
    wgmma_ss_n64(d, da, db, scale_d);
  }
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db, 1);
  } else {
    wgmma_rs_n128(o, a, db, 1);
  }
}

// x rounded to tf32 (10 fraction bits), to nearest, ties away from zero.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split4(const float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                   tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
}

// An fp32 tile of BYTES split by NT threads: hi over the tile itself, lo
// at the same offsets in `lo` (both tiles keep TMA's swizzled layout).
template <int BYTES, int NT>
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* lo, int t) {
#pragma unroll
  for (int i = 0; i < BYTES / 16 / NT; ++i) {
    const int off = (t + NT * i) * 16;
    float4* p = reinterpret_cast<float4*>(raw + off);
    float4 h, l;
    split4(*p, h, l);
    *p = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// The raw V tile ([key][d], boxes of 32 d) into V^T hi and lo ([d][pos],
// boxes of 32 positions), position 8 kk + p holding key 8 kk + 2 p for p <
// 4 and 8 kk + 2 (p - 4) + 1 for p >= 4.  A thread takes a column d and 4
// keys of one parity, which are one 16-byte chunk of a V^T row.
template <class C>
__device__ __forceinline__ void split_v(const uint8_t* raw, uint8_t* hi,
                                        uint8_t* lo, int t) {
  constexpr int D = C::D, NT = C::kConsumers;
#pragma unroll
  for (int it = 0; it < D * C::BK / 4 / NT; ++it) {
    const int j = t + NT * it;
    const int d = j % D, grp = j / D;        // grp = 2 kk + half
    const int kk = grp >> 1, half = grp & 1, pos = 4 * grp;
    const uint8_t* col = raw + (d / 32) * C::kKVBox + (d % 4) * 4;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 8 * kk + 2 * i + half;
      x[i] = *reinterpret_cast<const float*>(
          col + key * kRow + ((((d % 32) / 4) ^ (key % 8)) * 16));
    }
    float4 h, l;
    split4(make_float4(x[0], x[1], x[2], x[3]), h, l);
    const int off =
        (pos / 32) * C::kVtBox + d * kRow + ((((pos % 32) / 4) ^ (d % 8)) * 16);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// S (+)= A B^T over D / 8 k-steps: A the 64 x D tile at `q`, B the BK x D
// tile at `k`, both in boxes of 32 columns.
template <class C, bool kFirst>
__device__ __forceinline__ void qk_pass(float (&sc)[C::BK / 2], uint32_t q,
                                        uint32_t k) {
#pragma unroll
  for (int ks = 0; ks < C::D / 8; ++ks)
    wgmma_qk<C::BK>(sc, sw128_desc(q + (ks / 4) * kQBox + (ks % 4) * 32, 16,
                                   1024),
                    sw128_desc(k + (ks / 4) * C::kKVBox + (ks % 4) * 32, 16,
                               1024),
                    kFirst && ks == 0 ? 0 : 1);
}

// O += P V^T-tile over BK / 8 k-steps, P's fragments in registers.
template <class C>
__device__ __forceinline__ void pv_pass(float (&o)[C::D / 2],
                                        uint32_t (&p)[C::BK / 8][4],
                                        uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < C::BK / 8; ++kk)
    wgmma_pv<C::D>(o, p[kk],
                   sw128_desc(vt + (kk / 4) * C::kVtBox + (kk % 4) * 32, 16,
                              1024));
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
  int last;      // its last query row
  int t_begin;   // its first KV tile
  int n_tiles;
};

template <class C>
__device__ __forceinline__ Walk walk(const FlashArgs& a) {
  const int rows = kQRows * C::NWG;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows;   // heaviest first
  const int last = min(q0 + rows, a.s) - 1;
  const int t_begin = a.window > 0 ? max(0, q0 - a.window + 1) / C::BK : 0;
  return {q0, last, t_begin, last / C::BK - t_begin + 1};
}

// The producer: one thread loads the Q tiles, then streams K and V.
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const FlashArgs& a, uint32_t sa,
                                        Bars bars, Walk w) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  mbar_expect_tx(bars.q(), C::NWG * C::kQBytes);
#pragma unroll
  for (int g = 0; g < C::NWG; ++g)
#pragma unroll
    for (int c = 0; c < C::D / 32; ++c)
      tma_load(sa + C::kQhi + g * C::kQBytes + c * kQBox, tq, bars.q(),
               c * 32, w.q0 + g * kQRows, h, bb);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int c0 = (w.t_begin + i) * C::BK;
    mbar_wait(bars.empty(st), parity ^ 1);
    mbar_expect_tx(bars.k_full(st), C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::D / 32; ++c)
      tma_load(sa + C::kK + st * C::kTileBytes + c * C::kKVBox, tk,
               bars.k_full(st), c * 32, c0, hk, bb);
    mbar_expect_tx(bars.v_full(st), C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::D / 32; ++c)
      tma_load(sa + C::kV + st * C::kTileBytes + c * C::kKVBox, tv,
               bars.v_full(st), c * 32, c0, hk, bb);
  }
}

// The consumers: thread tc of kConsumers; warpgroup wg owns 64 query rows.
template <class C>
__device__ __forceinline__ void consume(const FlashArgs& a, uint8_t* sm,
                                        uint32_t sa, Bars bars, Walk w) {
  constexpr int D = C::D, BK = C::BK, NJ = BK / 8, NT = C::kConsumers;
  const int tc = threadIdx.x;
  const int wg = tc / 128, t = tc % 128;
  const int warp = t / 32, lane = t % 32;
  const int r_lo = w.q0 + wg * kQRows;
  const int r_hi = min(r_lo + kQRows - 1, a.s - 1);
  const bool has_rows = r_lo < a.s;
  const int row0 = r_lo + warp * 16 + lane / 4;   // and row0 + 8
  const int row1 = row0 + 8;
  const int colq = (lane % 4) * 2;    // the thread's first column of each 8
  const uint32_t q_hi = sa + C::kQhi + wg * C::kQBytes;
  const uint32_t q_lo = sa + C::kQlo + wg * C::kQBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  mbar_wait(bars.q(), 0);
  split_tile<C::NWG * C::kQBytes, NT>(sm + C::kQhi, sm + C::kQlo, tc);
  fence_proxy_async();
  bar_sync_first<NT>();

  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int c0 = (w.t_begin + i) * BK;
    // whether any (row, col) of this warpgroup's rows and this tile is
    // kept (the same for its 128 threads, as wgmma needs), and whether
    // any of the CTA's rows may be (the same for all consumers, as the
    // shared splits and their barriers need)
    const bool live = has_rows && c0 <= r_hi &&
                      (a.window <= 0 || c0 + BK - 1 > r_lo - a.window);
    const bool any_live =
        c0 <= w.last && (a.window <= 0 || c0 + BK - 1 > w.q0 - a.window);
    const uint32_t k_hi = sa + C::kK + st * C::kTileBytes;
    mbar_wait(bars.k_full(st), parity);
    if (any_live) {
      split_tile<C::kTileBytes, NT>(sm + C::kK + st * C::kTileBytes,
                                    sm + C::kKlo, tc);
      fence_proxy_async();
      bar_sync_first<NT>();
    }
    float sc[BK / 2];
    uint32_t p_hi[NJ][4], p_lo[NJ][4];
    if (live) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      fence_regs(sc);
      wgmma_fence();
      qk_pass<C, true>(sc, q_hi, sa + C::kKlo);
      qk_pass<C, false>(sc, q_lo, k_hi);
      qk_pass<C, false>(sc, q_hi, k_hi);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // sc[4 j + e]: row e < 2 ? row0 : row1, column c0 + 8 j + colq + e % 2
      // scale and softcap, then the mask, each a loop of its own behind a
      // branch that is the same for the warpgroup
      if (a.softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          sc[j] = a.softcap * tanhf(sc[j] * a.scale / a.softcap);
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] *= a.scale;
      }
      if (c0 + BK - 1 > r_lo || (a.window > 0 && c0 <= r_hi - a.window)) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
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
      for (int j = 0; j < NJ; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float corr0 = m0 > kNeg / 2 ? exp2f((m0 - mn0) * kLog2e) : 0.f;
      const float corr1 = m1 > kNeg / 2 ? exp2f((m1 - mn1) * kLog2e) : 0.f;
      // p = exp2(x log2e - max log2e); a row with nothing kept yet
      // subtracts 0, so that its kNeg scores give 0
      const float mb0 = mn0 > kNeg / 2 ? mn0 * kLog2e : 0.f;
      const float mb1 = mn1 > kNeg / 2 ? mn1 * kLog2e : 0.f;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
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

      // register A of k-step kk: (row0, key 2t), (row1, 2t), (row0, 2t + 1),
      // (row1, 2t + 1) of the kk-th group of 8 keys
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        const float pa[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                             sc[4 * kk + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float h = tf32_rna(pa[r]);
          p_hi[kk][r] = __float_as_uint(h);
          p_lo[kk][r] = __float_as_uint(tf32_rna(pa[r] - h));
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }
    }

    mbar_wait(bars.v_full(st), parity);
    if (any_live) {
      split_v<C>(sm + C::kV + st * C::kTileBytes, sm + C::kVthi,
                 sm + C::kVtlo, tc);
      fence_proxy_async();
      bar_sync_first<NT>();
    }
    if (live) {
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
      pv_pass<C>(o, p_lo, sa + C::kVthi);
      pv_pass<C>(o, p_hi, sa + C::kVtlo);
      pv_pass<C>(o, p_hi, sa + C::kVthi);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
    }
    // one arrival a warp, once the warp is past its last read of the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.empty(st));
  }

  if (!has_rows) return;
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  float* og = static_cast<float*>(a.o) + blockIdx.z * a.o_st[0] +
              blockIdx.y * a.o_st[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + colq;
    if (row0 < a.s)
      *reinterpret_cast<float2*>(og + row0 * a.o_st[2] + col) =
          make_float2(o[4 * j] / den0, o[4 * j + 1] / den0);
    if (row1 < a.s)
      *reinterpret_cast<float2*>(og + row1 * a.o_st[2] + col) =
          make_float2(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const FlashArgs a) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t sa = (raw_u32 + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (sa - raw_u32);
  const Bars bars{sa + C::kBarOff};
  const Walk w = walk<C>(a);

  if (threadIdx.x == 0) {
    mbar_init(bars.q(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.empty(s), C::kConsumers / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::kConsumers) {
    if (threadIdx.x == C::kConsumers)
      produce<C>(&tq, &tk, &tv, a, sa, bars, w);
  } else {
    consume<C>(a, sm, sa, bars, w);
  }
}

// ---- host ---------------------------------------------------------------

template <class C>
int launch(const FlashArgs& a, cudaStream_t stream) {
  auto kernel = flash_tf32_kernel<C>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = make_map(&tq, a.q, a.q_st, C::D, a.s, a.hq, a.b, kF32, 4, kQRows);
  if (!err)
    err = make_map(&tk, a.k, a.k_st, C::D, a.s, a.hkv, a.b, kF32, 4, C::BK);
  if (!err)
    err = make_map(&tv, a.v, a.v_st, C::D, a.s, a.hkv, a.b, kF32, 4, C::BK);
  if (err) return err;
  const int rows = kQRows * C::NWG;
  const dim3 grid((a.s + rows - 1) / rows, a.hq, a.b);
  kernel<<<grid, C::kThreads, C::kSmemAlloc, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention_tf32(const FlashArgs* args,
                                          cudaStream_t stream) {
  const FlashArgs& a = *args;
  if (a.bf16 || a.dv != a.d || a.hkv < 1 || a.hq % a.hkv || a.b < 1 ||
      a.hq < 1 || a.b > 65535 || a.hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.s < 1) return 0;
  switch (a.d) {
    case 64: return launch<Cfg<64, 64, 2>>(a, stream);
    case 128: return launch<Cfg<128, 32, 1>>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
