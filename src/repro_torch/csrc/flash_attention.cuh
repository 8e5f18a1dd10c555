// The argument block of B8's two kernels (flash_attention.cu, the SIMT
// kernel; flash_attention_wgmma.cu, the tensor-core kernel).  Mirrored field
// for field by the ctypes Structure in
// repro_torch/kernels/flash_attention/ops.py.  Strides are in elements, in
// the order (b, h, s); the d stride is 1.  q and k are (B, H, S, d), v and
// o (B, H, S, dv): MLA's values are narrower than its queries and keys.
#pragma once

#include <cstdint>

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
  int d;         // width of q and k
  int dv;        // width of v and o
  int window;
  float scale;
  float softcap;
  int bf16;      // 0: float32, 1: bfloat16 (all four tensors)
};
