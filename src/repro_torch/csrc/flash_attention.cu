// B8: causal GQA flash attention (online softmax), fp32 and bf16.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (body _flash_kernel).  No module of the JAX
//   package calls it; its docstring names it the TPU runtime replacement of
//   the blocking of repro.models.attention.flash_chunked, so in the port
//   flash_chunked launches it on a CUDA tensor: every layer of
//   LMModel.hidden_states (MusicGen-large: 48 layers, 32 heads of 64, S =
//   24 in the latents pipeline, up to S = 1500 for 30 s of frames).
//
// Computes, for query head h reading KV head h / (Hq / Hkv):
//   s = (q . k) * scale (default D^-0.5); s = softcap * tanh(s / softcap)
//   when softcap > 0, before the running max; mask col <= row and, with a
//   window, col > row - window; online softmax with an fp32 running max,
//   denominator and accumulator; a fully masked row gives 0; the output is
//   written in q's dtype.  S of any length: the last tiles are masked, not
//   padded.  Any D from 8 to 256 in steps of 8.  The four tensors are read
//   and written through (b, h, s) strides with a unit d stride, so the
//   model's (B, S, H, D) layout needs no transpose copy.
//
// Bound on the H100: operations.  Causal attention does 2 B Hq S^2 D flops
//   (QK^T and PV over the lower triangle) against 2 B S D (Hq + 2 Hkv)
//   bytes-per-element of q, k, v, o: at MusicGen's prefill shape (B 4, S
//   1500, 32 heads of 64, bf16) 36.9 GFLOP, 0.037 ms at 989 TFLOP/s bf16,
//   against 0.015 ms for the bytes.  This first kernel does not reach the
//   tensor cores: it computes in fp32 FMA (67 TFLOP/s peak), so it cannot
//   come within 15x of that bound; wgmma with TMA-fed tiles is later work.
//
// Design: one block per (query tile of kBQ = 32 rows, head, batch) -- the
//   TPU's sequential "arbitrary" KV grid axis becomes a loop over KV tiles
//   of kBK = 32 keys inside the block, from the first tile the window can
//   reach to the tile holding the block's last row (tiles wholly above the
//   diagonal or outside the window are skipped, not masked).  The q tile
//   and each K and V tile are staged in shared memory as fp32.  Four warps
//   own eight query rows each; lane j scores key j of the tile for all
//   eight rows at once (float4 loads, K rows padded to D + 4 floats so a
//   quarter-warp's 16-byte loads hit distinct banks), the row max and sum
//   are warp reductions, and for P.V lane l accumulates output columns l,
//   l + 32, ... of its rows in registers, reading p from shared memory.
//   Shared memory is 4 (96 D + 1152) bytes: above 48 KB (D >= 128) the
//   launch raises the kernel's dynamic shared-memory limit first.
#include <cuda_bf16.h>

#include "common.cuh"

// Mirrored field for field by the ctypes Structure in
// repro_torch/kernels/flash_attention/ops.py.  Strides are in elements, in
// the order (b, h, s); the d stride is 1.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_st[3];
  int64_t k_st[3];
  int64_t v_st[3];
  int64_t o_st[3];
  int b;
  int hq;
  int hkv;
  int s;
  int d;
  int window;
  float scale;
  float softcap;
  int bf16;      // 0: float32, 1: bfloat16 (all four tensors)
};

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBK = 32;                  // keys per KV tile: one per lane
constexpr float kNeg = -1e30f;           // the JAX kernel's _NEG_INF

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
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(repro::kFullMask, v, off);
  return v;
}

__host__ __device__ inline size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * d +
                          static_cast<size_t>(kBK) * (d + 4) +
                          static_cast<size_t>(kBK) * d + kBQ * kBK);
}

// NI = ceil(D / 32): output columns per lane.
template <typename T, int NI>
__global__ void __launch_bounds__(kWarps * 32)
    flash_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int D = a.d;
  const int ldk = D + 4;
  float* qs = sm;                   // (kBQ, D)
  float* ks = qs + kBQ * D;         // (kBK, D + 4)
  float* vs = ks + kBK * ldk;       // (kBK, D)
  float* ps = vs + kBK * D;         // (kBQ, kBK) probabilities

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const T* qg = static_cast<const T*>(a.q) + bb * a.q_st[0] + h * a.q_st[1];
  const T* kg = static_cast<const T*>(a.k) + bb * a.k_st[0] + hk * a.k_st[1];
  const T* vg = static_cast<const T*>(a.v) + bb * a.v_st[0] + hk * a.v_st[1];
  T* og = static_cast<T*>(a.o) + bb * a.o_st[0] + h * a.o_st[1];

  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = q0 + r;
    qs[i] = row < a.s ? to_f(qg[row * a.q_st[2] + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NI];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }

  const int last_row = min(q0 + kBQ, a.s) - 1;
  const int first_col = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const float* qw = qs + w * kRows * D;
  float* pw = ps + w * kRows * kBK;
  for (int t = first_col / kBK; t <= last_row / kBK; ++t) {
    const int c0 = t * kBK;
    __syncthreads();   // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBK * D; i += kWarps * 32) {
      const int j = i / D;
      const int c = i - j * D;
      const int col = c0 + j;
      const bool in = col < a.s;
      ks[j * ldk + c] = in ? to_f(kg[col * a.k_st[2] + c]) : 0.f;
      vs[j * D + c] = in ? to_f(vg[col * a.v_st[2] + c]) : 0.f;
    }
    __syncthreads();

    // scores of key c0 + lane against the warp's rows
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    const float* kr = ks + lane * ldk;
    for (int c = 0; c < D; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * D + c);
        sc[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    const int col = c0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + w * kRows + r;
      float x = sc[r] * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      // col <= row < S also keeps the masked tail of the last tile out
      const bool ok = row < a.s && col <= row &&
                      (a.window <= 0 || col > row - a.window);
      x = ok ? x : kNeg;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = (ok && m_new > kNeg / 2) ? expf(x - m_new) : 0.f;
      const float corr = m[r] > kNeg / 2 ? expf(m[r] - m_new) : 0.f;
      l[r] = corr * l[r] + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= corr;
      pw[r * kBK + lane] = p;
    }
    __syncwarp();

    // acc[r][i] += sum_j p[r][j] v[j][lane + 32 i]
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][NI];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int c = lane + 32 * i;
          vv[jj][i] = c < D ? vs[(j + jj) * D + c] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * kBK + j);
#pragma unroll
        for (int i = 0; i < NI; ++i)
          acc[r][i] += p4.x * vv[0][i] + p4.y * vv[1][i] + p4.z * vv[2][i] +
                       p4.w * vv[3][i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + w * kRows + r;
    if (row >= a.s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = lane + 32 * i;
      if (c < D) og[row * a.o_st[2] + c] = from_f<T>(acc[r][i] / den);
    }
  }
}

template <typename T, int NI>
int launch(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.hq, a.b);
  flash_kernel<T, NI><<<grid, kWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const FlashArgs& a, cudaStream_t stream) {
  switch ((a.d + 31) / 32) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 4: return launch<T, 4>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 6: return launch<T, 6>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 8: return launch<T, 8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_flash_attention(const FlashArgs* args,
                                     cudaStream_t stream) {
  const FlashArgs& a = *args;
  if (a.d < 8 || a.d > 256 || a.d % 8 || a.hkv < 1 || a.hq % a.hkv ||
      a.b < 1 || a.hq < 1 || a.b > 65535 || a.hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.s < 1) return 0;
  return a.bf16 ? dispatch<__nv_bfloat16>(a, stream)
                : dispatch<float>(a, stream);
}
