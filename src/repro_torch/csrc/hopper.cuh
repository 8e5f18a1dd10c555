// Hopper building blocks of B8's two tensor-core kernels
// (flash_attention_wgmma.cu for bf16, flash_attention_tf32.cu for float32)
// and of B2/B4's ring route (knn_merge.cu: mbarriers, 1-D bulk copies):
// PTX wrappers for mbarriers, TMA loads and the wgmma fences, the
// shared-memory descriptors of a 128-byte- and a 32-byte-swizzled tile, and
// the host's tensor map of a (B, H, S, D) view.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums; no libcuda call
#include <cuda_runtime.h>

#include "common.cuh"

namespace hopper {

constexpr long long kHangCycles = 1LL << 34;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (PTX ISA,
// mbarrier.try_wait.parity: a fresh barrier is in phase 0, so parity 1
// passes at once).  A wait that has not completed after kHangCycles (about
// 10 s) traps, so a fault in a pipeline ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long t = clock64();
    if (t0 == 0) {
      t0 = t;
    } else if (t - t0 > kHangCycles) {
      __trap();
    }
  }
}

// One box of the 4-D map at coordinates (d, s, h, b) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, by the TMA's 1-D bulk copy; completes its bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma, TMA) of the CTA; then a barrier orders them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier 1 over the first N threads of the CTA (a multiple of 32).
template <int N>
__device__ __forceinline__ void bar_sync_first() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type 1
// in bits 62-63), start address in 16-byte units; LBO and SBO in bytes.
// K-major: SBO = 1024, the stride of 8 rows of 128 bytes; LBO is not read.
// MN-major (bf16 V): SBO = 1024 between groups of 8 keys, LBO = the stride
// between 64-column boxes along D.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The same for a 32-byte-swizzled tile (layout type 3), MN-major one
// 16-element atom wide (bf16 V's 16-column tail at Dv = 80): SBO = 256, the
// stride of 8 rows of 32 bytes; LBO, the stride between atoms along N, is
// not read at N = 16.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(repro::kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(repro::kFullMask, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(repro::kFullMask, v, 1);
  return v + __shfl_xor_sync(repro::kFullMask, v, 2);
}

// ---- host ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver at run time, so that the
// library does not link libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (D, S, H, B) of one (B, H, S, D) view with element strides
// st (b, h, s), in boxes of `box_bytes` (128 or 32) of D by `box_rows` rows
// of S, in the swizzle of that width.  TMA zero-fills the rows past S and
// the columns past D.
inline int make_map(CUtensorMap* map, const void* ptr, const int64_t st[3],
                    int d, int s, int h, int b, CUtensorMapDataType dtype,
                    int elem_bytes, int box_rows, int box_bytes = 128) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return repro::kErrNoEncodeTiled;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * elem_bytes,
                                 static_cast<cuuint64_t>(st[1]) * elem_bytes,
                                 static_cast<cuuint64_t>(st[0]) * elem_bytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_bytes / elem_bytes),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, dtype, 4, const_cast<void*>(ptr), dims, strides,
                         box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                          : CU_TENSOR_MAP_SWIZZLE_32B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : repro::kErrTensorMap + static_cast<int>(r);
}

}  // namespace hopper
