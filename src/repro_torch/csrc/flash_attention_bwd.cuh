// The argument block of B8's backward, shared by its two routes:
// flash_attention_bwd.cu (SIMT: float32, and bf16 outside the tensor-core
// widths) and flash_attention_bwd_wgmma.cu (bf16 on the tensor cores).
#pragma once

#include <cstdint>

// The argument block, mirrored field for field by the ctypes Structure
// _FlashBwdArgs in repro_torch/kernels/flash_attention/ops.py.  Strides are
// in elements, in the order (b, h, s); the last stride is 1.  q, k and dq,
// dk are (B, H, S, d); v, o, g_o (dL/dO) and dv are (B, H, S, dv).  lse and
// delta are float32 (B, Hq, S) scratch, contiguous; the tensor-core route
// pads S to a multiple of 64 rows (see its launcher).
struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g_o;
  void* g_q;
  void* g_k;
  void* g_v;
  float* lse;
  float* delta;
  int64_t q_st[3];
  int64_t k_st[3];
  int64_t v_st[3];
  int64_t o_st[3];
  int64_t go_st[3];
  int64_t gq_st[3];
  int64_t gk_st[3];
  int64_t gv_st[3];
  int b;
  int hq;
  int hkv;
  int s;
  int d;
  int dv;
  int window;
  float scale;
  float softcap;
  int bf16;
};
