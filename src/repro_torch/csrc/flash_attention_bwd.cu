// B8's backward: dQ, dK and dV of causal GQA flash attention, SIMT, fp32
// and bf16, D (q and k) and Dv (v and out) each from 8 to 256 in steps of 8.
// kernels/flash_attention/ops.py (launch_bwd, bwd_route) calls it from the
// backward of models.attention.FlashAttention, so gradients flow through B8
// on the card.  It is the route for float32 and for bf16 at the widths
// outside WGMMA_DV; bf16 at those takes the tensor-core backward,
// flash_attention_bwd_wgmma.cu.
//
// Replaces: no TPU kernel.  The JAX package's Pallas kernel
//   (src/repro/kernels/flash_attention/kernel.py, flash_attention_pallas)
//   is forward only, and the JAX model trains through the jnp scan of
//   repro.models.attention.flash_chunked, whose gradient XLA derives.  The
//   port's forward on the card is a kernel, so its backward is one too.
//
// Computes, in float32 whatever the input type, for query head h reading
// KV head h / (Hq / Hkv), the gradients of B8's forward (the same scores:
// raw = (q . k) * scale, s = softcap * tanh(raw / softcap) under a softcap,
// the mask col <= row and, with a window, col > row - window):
//   lse_i = log sum_j exp(s_ij) over the keys row i sees, recomputed (the
//     forward's three kernels keep no statistics);
//   delta_i = sum_c dO_ic O_ic;  P_ij = exp(s_ij - lse_i), 0 where masked;
//   dV_j = sum_i P_ij dO_i;  dP_ij = dO_i . V_j;  dS_ij = P_ij (dP_ij -
//   delta_i), times 1 - tanh^2(raw_ij / softcap) under a softcap;
//   dQ_i = scale sum_j dS_ij K_j;  dK_j = scale sum_i dS_ij Q_i, dK and dV
//   summed over the query heads of the KV head's group.
// The plain version is kernels/flash_attention/ref.py,
// flash_attention_bwd_ref.
//
// Bound on the H100: operations.  Over the kept (row, col) pairs the three
//   kernels do 2 (4 D + 2 Dv) flops a pair a query head: the scores twice
//   more than the forward (lse here, then in each of the other two kernels),
//   dP twice, dV, dK and dQ once each, counted with the recomputed scores.
//   In fp32 FMA at 67 TFLOP/s outside the tensor cores: the simple design,
//   kept for float32 (a 3xTF32 tensor-core backward is queued) and the
//   widths no tensor-core kernel of B8 takes.
//
// Design: three kernels on the stream, no atomics: every output element is
//   written by one thread, and every sum is taken in a fixed order, so that
//   two launches give the same bits and a train step on the card repeats.
//   Tiles are kT = 32 query rows by kT = 32 keys; a block has eight warps,
//   warp w owns rows 4w .. 4w + 3 of a tile and lane j key j, so a score
//   (and a dP) is a lane's float4 loop over a K row (padded to D + 4 floats,
//   so a quarter-warp's 16-byte loads hit distinct banks) against the
//   warp's broadcast Q rows, as in the SIMT forward.  Tiles wholly above the
//   diagonal or outside the window are skipped.
//   (i)   pre: one block per (query tile, head, batch) walks the key tiles
//         with an online max and sum (warp reductions) and writes each
//         row's lse and delta to float32 (B, Hq, S) scratch.
//   (ii)  dkdv: one block per (key tile, KV head, batch) holds its K and V
//         tiles and float32 dK and dV accumulators in shared memory, and
//         walks the group's query heads and, in each, the query tiles that
//         see its keys (rows j .. j + window - 1 with a window); P and dS
//         of a tile go through shared memory, and each thread adds four
//         adjacent columns of one key row over the tile's 32 rows in order.
//   (iii) dq: one block per (query tile, head, batch) holds its Q and dO
//         tiles and a float32 dQ accumulator, walks the key tiles as the
//         forward does, and adds dS K the same way.
//   Shared memory holds up to 32 (4 D + 4 Dv + 8) + 2 * 32 * 33 + 64
//   floats (dkdv: 206 KB at D = Dv = 256), so each launch first raises its
//   kernel's dynamic shared-memory limit.
#include <cuda_bf16.h>

#include "common.cuh"
#include "flash_attention_bwd.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsW = 4;               // query rows per warp
constexpr int kT = kWarps * kRowsW;     // rows of a query tile, keys of a key tile
constexpr int kLdP = kT + 1;            // row stride of the P and dS tiles
constexpr float kNeg = -1e30f;          // the forward's masked score

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(repro::kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1)
    v += __shfl_xor_sync(repro::kFullMask, v, off);
  return v;
}

// kT rows from row0 of a (S, width) slice with row stride `st` into shared
// memory as float32 with row stride `ld`; rows past S are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t st, int row0, int s,
                                      int width) {
  for (int i = threadIdx.x; i < kT * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    const int row = row0 + r;
    dst[r * ld + c] = row < s ? to_f(src[row * st + c]) : 0.f;
  }
}

// acc[rr] = a-row (4w + rr) . b-row lane, over `width` columns (a multiple
// of 4): the warp's rows of `a` are broadcast, lane j reads b's row j.
__device__ __forceinline__ void dots(const float* a, int lda, const float* b,
                                     int ldb, int width, int w, int lane,
                                     float acc[kRowsW]) {
#pragma unroll
  for (int rr = 0; rr < kRowsW; ++rr) acc[rr] = 0.f;
  const float* br = b + lane * ldb;
  const float* aw = a + w * kRowsW * lda;
  for (int c = 0; c < width; c += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(br + c);
#pragma unroll
    for (int rr = 0; rr < kRowsW; ++rr) {
      const float4 av = *reinterpret_cast<const float4*>(aw + rr * lda + c);
      acc[rr] += av.x * bv.x + av.y * bv.y + av.z * bv.z + av.w * bv.w;
    }
  }
}

__device__ __forceinline__ bool kept(const FlashBwdArgs& a, int row,
                                     int col) {
  return row < a.s && col <= row && (a.window <= 0 || col > row - a.window);
}

// The score s of a raw dot product (scaled, then capped), and the cap's
// derivative ds/draw (1 without a cap).
__device__ __forceinline__ float score(const FlashBwdArgs& a, float dot,
                                       float* dcap) {
  const float raw = dot * a.scale;
  if (a.softcap > 0.f) {
    const float t = tanhf(raw / a.softcap);
    *dcap = 1.f - t * t;
    return a.softcap * t;
  }
  *dcap = 1.f;
  return raw;
}

// acc[r][4c .. 4c + 3] += sum_r' p[r'][r] src[r'][4c ..] over the kT rows
// r' in order (p transposed: dV and dK) or acc[r][..] += sum_j p[r][j]
// src[j][..] (dQ), for every (r, 4c) of a kT x width accumulator; one
// thread owns each group of four columns.
template <bool kTransposed>
__device__ __forceinline__ void accumulate(float* acc, int width,
                                           const float* p, const float* src,
                                           int ld_src) {
  const int groups = width / 4;
  for (int g = threadIdx.x; g < kT * groups; g += kThreads) {
    const int r = g / groups;
    const int c = (g - r * groups) * 4;
    float4 s = *reinterpret_cast<float4*>(acc + r * width + c);
    for (int j = 0; j < kT; ++j) {
      const float w = kTransposed ? p[j * kLdP + r] : p[r * kLdP + j];
      const float4 x = *reinterpret_cast<const float4*>(src + j * ld_src + c);
      s.x += w * x.x;
      s.y += w * x.y;
      s.z += w * x.z;
      s.w += w * x.w;
    }
    *reinterpret_cast<float4*>(acc + r * width + c) = s;
  }
}

// A kT x width float32 accumulator (times `mul`) into rows row0.. of a
// (S, width) slice of type T.
template <typename T>
__device__ __forceinline__ void store(T* dst, int64_t st, const float* acc,
                                      int row0, int s, int width,
                                      float mul) {
  for (int i = threadIdx.x; i < kT * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    const int row = row0 + r;
    if (row < s) dst[row * st + c] = from_f<T>(acc[i] * mul);
  }
}

// The first key tile and the last query tile that a query tile / key tile
// reaches (causal, windowed).
__device__ __forceinline__ int first_key_tile(const FlashBwdArgs& a,
                                              int q0) {
  return (a.window > 0 ? max(0, q0 - a.window + 1) : 0) / kT;
}
__device__ __forceinline__ int last_query_tile(const FlashBwdArgs& a,
                                               int j0) {
  const int last_key = min(j0 + kT, a.s) - 1;
  const int last_row =
      a.window > 0 ? min(a.s - 1, last_key + a.window - 1) : a.s - 1;
  return last_row / kT;
}

// (i) each row's lse and delta.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_pre_kernel(const FlashBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int D = a.d;
  const int ldk = D + 4;
  float* qs = sm;                   // (kT, D)
  float* ks = qs + kT * D;          // (kT, D + 4)
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const T* qg = static_cast<const T*>(a.q) + bb * a.q_st[0] + h * a.q_st[1];
  const T* kg = static_cast<const T*>(a.k) + bb * a.k_st[0] + hk * a.k_st[1];
  const T* og = static_cast<const T*>(a.o) + bb * a.o_st[0] + h * a.o_st[1];
  const T* gog =
      static_cast<const T*>(a.g_o) + bb * a.go_st[0] + h * a.go_st[1];
  const int64_t row_base = (static_cast<int64_t>(bb) * a.hq + h) * a.s;

  stage(qs, D, qg, a.q_st[2], q0, a.s, D);
  float m[kRowsW], l[kRowsW];
#pragma unroll
  for (int rr = 0; rr < kRowsW; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
  }
  const int last_row = min(q0 + kT, a.s) - 1;
  for (int t = first_key_tile(a, q0); t <= last_row / kT; ++t) {
    const int c0 = t * kT;
    __syncthreads();   // the previous tile is consumed (and q is staged)
    stage(ks, ldk, kg, a.k_st[2], c0, a.s, D);
    __syncthreads();
    float sc[kRowsW];
    dots(qs, D, ks, ldk, D, w, lane, sc);
    const int col = c0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsW; ++rr) {
      const int row = q0 + w * kRowsW + rr;
      float dcap;
      const bool ok = kept(a, row, col);
      const float x = ok ? score(a, sc[rr], &dcap) : kNeg;
      const float m_new = fmaxf(m[rr], warp_max(x));
      const float p = (ok && m_new > kNeg / 2) ? expf(x - m_new) : 0.f;
      const float corr = m[rr] > kNeg / 2 ? expf(m[rr] - m_new) : 0.f;
      l[rr] = corr * l[rr] + warp_sum(p);
      m[rr] = m_new;
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsW; ++rr) {
    const int row = q0 + w * kRowsW + rr;
    if (row >= a.s) continue;            // warp-uniform
    float acc = 0.f;
    for (int c = lane; c < a.dv; c += 32)
      acc += to_f(gog[row * a.go_st[2] + c]) * to_f(og[row * a.o_st[2] + c]);
    acc = warp_sum(acc);
    if (lane == 0) {
      // a row that sees no key (none in causal self-attention) gets
      // lse = +inf, so that its P is exp(-inf) = 0
      a.lse[row_base + row] = l[rr] > 0.f ? m[rr] + logf(l[rr])
                                    : __int_as_float(0x7f800000);
      a.delta[row_base + row] = acc;
    }
  }
}

// P and dS of one (query tile q0, key tile j0) pair into shared memory,
// from the staged Q (kT, D), dO (kT, Dv), K (kT, D + 4), V (kT, Dv + 4) and
// the rows' lse and delta.
__device__ __forceinline__ void p_and_ds(const FlashBwdArgs& a,
                                         const float* qs, const float* gos,
                                         const float* ks, const float* vs,
                                         const float* lse, const float* dlt,
                                         int q0, int j0, float* ps,
                                         float* dss) {
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float sc[kRowsW], dp[kRowsW];
  dots(qs, a.d, ks, a.d + 4, a.d, w, lane, sc);
  dots(gos, a.dv, vs, a.dv + 4, a.dv, w, lane, dp);
  const int col = j0 + lane;
#pragma unroll
  for (int rr = 0; rr < kRowsW; ++rr) {
    const int r = w * kRowsW + rr;
    const int row = q0 + r;
    float p = 0.f, ds = 0.f;
    if (kept(a, row, col)) {
      float dcap;
      const float s = score(a, sc[rr], &dcap);
      p = expf(s - lse[r]);
      ds = p * (dp[rr] - dlt[r]) * dcap;
    }
    if (ps) ps[r * kLdP + lane] = p;
    dss[r * kLdP + lane] = ds;
  }
}

// The rows' lse and delta of a query tile into shared memory.
__device__ __forceinline__ void stage_stats(const FlashBwdArgs& a,
                                            int64_t row_base, int q0,
                                            float* lse, float* dlt) {
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    const int row = q0 + r;
    lse[r] = row < a.s ? a.lse[row_base + row] : 0.f;
    dlt[r] = row < a.s ? a.delta[row_base + row] : 0.f;
  }
}

// (ii) dK and dV of a key tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const FlashBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int D = a.d;
  const int DV = a.dv;
  float* ks = sm;                       // (kT, D + 4)
  float* vs = ks + kT * (D + 4);        // (kT, Dv + 4)
  float* qs = vs + kT * (DV + 4);       // (kT, D)
  float* gos = qs + kT * D;             // (kT, Dv)
  float* gks = gos + kT * DV;           // (kT, D) accumulator
  float* gvs = gks + kT * D;            // (kT, Dv) accumulator
  float* ps = gvs + kT * DV;            // (kT, kT + 1)
  float* dss = ps + kT * kLdP;          // (kT, kT + 1)
  float* lse = dss + kT * kLdP;         // (kT,)
  float* dlt = lse + kT;                // (kT,)

  const int j0 = blockIdx.x * kT;
  const int hk = blockIdx.y;
  const int bb = blockIdx.z;
  const int group = a.hq / a.hkv;
  const T* kg = static_cast<const T*>(a.k) + bb * a.k_st[0] + hk * a.k_st[1];
  const T* vg = static_cast<const T*>(a.v) + bb * a.v_st[0] + hk * a.v_st[1];
  stage(ks, D + 4, kg, a.k_st[2], j0, a.s, D);
  stage(vs, DV + 4, vg, a.v_st[2], j0, a.s, DV);
  for (int i = threadIdx.x; i < kT * (D + DV); i += kThreads) gks[i] = 0.f;

  const int t_last = last_query_tile(a, j0);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qg = static_cast<const T*>(a.q) + bb * a.q_st[0] + h * a.q_st[1];
    const T* gog =
        static_cast<const T*>(a.g_o) + bb * a.go_st[0] + h * a.go_st[1];
    const int64_t row_base = (static_cast<int64_t>(bb) * a.hq + h) * a.s;
    for (int t = j0 / kT; t <= t_last; ++t) {
      const int q0 = t * kT;
      __syncthreads();   // the previous tile's P, dS, Q and dO are consumed
      stage(qs, D, qg, a.q_st[2], q0, a.s, D);
      stage(gos, DV, gog, a.go_st[2], q0, a.s, DV);
      stage_stats(a, row_base, q0, lse, dlt);
      __syncthreads();
      p_and_ds(a, qs, gos, ks, vs, lse, dlt, q0, j0, ps, dss);
      __syncthreads();
      accumulate<true>(gvs, DV, ps, gos, DV);   // dV_j += sum_i P_ij dO_i
      accumulate<true>(gks, D, dss, qs, D);     // dK_j += sum_i dS_ij Q_i
    }
  }
  __syncthreads();
  T* gkg = static_cast<T*>(a.g_k) + bb * a.gk_st[0] + hk * a.gk_st[1];
  T* gvg = static_cast<T*>(a.g_v) + bb * a.gv_st[0] + hk * a.gv_st[1];
  store(gkg, a.gk_st[2], gks, j0, a.s, D, a.scale);
  store(gvg, a.gv_st[2], gvs, j0, a.s, DV, 1.f);
}

// (iii) dQ of a query tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const FlashBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int D = a.d;
  const int DV = a.dv;
  float* ks = sm;                       // (kT, D + 4)
  float* vs = ks + kT * (D + 4);        // (kT, Dv + 4)
  float* qs = vs + kT * (DV + 4);       // (kT, D)
  float* gos = qs + kT * D;             // (kT, Dv)
  float* gqs = gos + kT * DV;           // (kT, D) accumulator
  float* dss = gqs + kT * D;            // (kT, kT + 1)
  float* lse = dss + kT * kLdP;         // (kT,)
  float* dlt = lse + kT;                // (kT,)

  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const T* qg = static_cast<const T*>(a.q) + bb * a.q_st[0] + h * a.q_st[1];
  const T* gog =
      static_cast<const T*>(a.g_o) + bb * a.go_st[0] + h * a.go_st[1];
  const T* kg = static_cast<const T*>(a.k) + bb * a.k_st[0] + hk * a.k_st[1];
  const T* vg = static_cast<const T*>(a.v) + bb * a.v_st[0] + hk * a.v_st[1];
  const int64_t row_base = (static_cast<int64_t>(bb) * a.hq + h) * a.s;
  stage(qs, D, qg, a.q_st[2], q0, a.s, D);
  stage(gos, DV, gog, a.go_st[2], q0, a.s, DV);
  stage_stats(a, row_base, q0, lse, dlt);
  for (int i = threadIdx.x; i < kT * D; i += kThreads) gqs[i] = 0.f;

  const int last_row = min(q0 + kT, a.s) - 1;
  for (int t = first_key_tile(a, q0); t <= last_row / kT; ++t) {
    const int j0 = t * kT;
    __syncthreads();   // the previous tile's K, V and dS are consumed
    stage(ks, D + 4, kg, a.k_st[2], j0, a.s, D);
    stage(vs, DV + 4, vg, a.v_st[2], j0, a.s, DV);
    __syncthreads();
    p_and_ds(a, qs, gos, ks, vs, lse, dlt, q0, j0, nullptr, dss);
    __syncthreads();
    accumulate<false>(gqs, D, dss, ks, D + 4);  // dQ_i += sum_j dS_ij K_j
  }
  __syncthreads();
  T* gqg = static_cast<T*>(a.g_q) + bb * a.gq_st[0] + h * a.gq_st[1];
  store(gqg, a.gq_st[2], gqs, q0, a.s, D, a.scale);
}

size_t pre_smem(int d) {
  return sizeof(float) * static_cast<size_t>(kT) * (2 * d + 4);
}
size_t dkdv_smem(int d, int dv) {
  return sizeof(float) * (static_cast<size_t>(kT) * (3 * d + 3 * dv + 8) +
                          2 * kT * kLdP + 2 * kT);
}
size_t dq_smem(int d, int dv) {
  return sizeof(float) * (static_cast<size_t>(kT) * (3 * d + 2 * dv + 8) +
                          kT * kLdP + 2 * kT);
}

template <typename K>
int launch_one(K kernel, dim3 grid, size_t smem, const FlashBwdArgs& a,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const FlashBwdArgs& a, cudaStream_t stream) {
  const int tiles = (a.s + kT - 1) / kT;
  int err = launch_one(bwd_pre_kernel<T>, dim3(tiles, a.hq, a.b),
                       pre_smem(a.d), a, stream);
  if (err) return err;
  err = launch_one(bwd_dkdv_kernel<T>, dim3(tiles, a.hkv, a.b),
                   dkdv_smem(a.d, a.dv), a, stream);
  if (err) return err;
  return launch_one(bwd_dq_kernel<T>, dim3(tiles, a.hq, a.b),
                    dq_smem(a.d, a.dv), a, stream);
}

}  // namespace

extern "C" int repro_flash_attention_bwd(const FlashBwdArgs* args,
                                         cudaStream_t stream) {
  const FlashBwdArgs& a = *args;
  if (a.d < 8 || a.d > 256 || a.d % 8 || a.dv < 8 || a.dv > 256 ||
      a.dv % 8 || a.hkv < 1 || a.hq % a.hkv || a.b < 1 || a.hq < 1 ||
      a.b > 65535 || a.hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.s < 1) return 0;
  return a.bf16 ? run<__nv_bfloat16>(a, stream) : run<float>(a, stream);
}
