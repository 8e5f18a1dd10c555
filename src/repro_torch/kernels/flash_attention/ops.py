"""Causal GQA flash attention (B8): the plain version on the CPU, the CUDA
kernel of ``csrc/flash_attention.cu`` on the card."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _FlashArgs(ctypes.Structure):
    """Field for field the ``FlashArgs`` struct of csrc/flash_attention.cu."""
    _fields_ = [
        ("q", _P), ("k", _P), ("v", _P), ("o", _P),
        ("q_st", _I64 * 3), ("k_st", _I64 * 3), ("v_st", _I64 * 3),
        ("o_st", _I64 * 3),
        ("b", _I), ("hq", _I), ("hkv", _I), ("s", _I), ("d", _I),
        ("window", _I), ("scale", _F), ("softcap", _F), ("bf16", _I),
    ]


def launch(q, k, v, out, *, scale: float, softcap: float = 0.0,
           window: int = 0) -> None:
    """Run B8 into ``out``.  All four are (B, H, S, D) views on one card,
    any (b, h, s) strides with a unit d stride: q and out (B, Hq, S, D),
    k and v (B, Hkv, S, D); one dtype, float32 or bfloat16."""
    req = _build.require
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    req(q.dtype in _DTYPES, f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t, h in (("k", k, hkv), ("v", v, hkv), ("out", out, hq)):
        req(t.dtype == q.dtype, f"{name} must have q's dtype {q.dtype}")
        req(tuple(t.shape) == (b, h, s, d),
            f"{name} must be ({b}, {h}, {s}, {d}), got {tuple(t.shape)}")
    req(hkv >= 1 and hq % hkv == 0, f"Hq = {hq} must be a multiple of Hkv = {hkv}")
    req(8 <= d <= 256 and d % 8 == 0, f"D = {d}: the kernel takes 8..256 in steps of 8")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        req(t.stride(3) == 1, f"{name} must have a unit stride over D")
    a = _FlashArgs(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                   o=out.data_ptr(), b=b, hq=hq, hkv=hkv, s=s, d=d,
                   window=int(window), scale=float(scale),
                   softcap=float(softcap), bf16=_DTYPES[q.dtype])
    for field, t in (("q_st", q), ("k_st", k), ("v_st", v), ("o_st", out)):
        getattr(a, field)[:] = t.stride()[:3]
    with torch.cuda.device(q.device):
        _build.call("repro_flash_attention", [ctypes.POINTER(_FlashArgs), _P],
                    ctypes.byref(a), _build.stream_of(q))
    LAUNCHES["flash_attention"] += 1


def flash_attention(q, k, v, *, scale: float | None = None,
                    softcap: float = 0.0, window: int = 0):
    """(B, Hq, S, D) x (B, Hkv, S, D)^2 -> (B, Hq, S, D) causal GQA
    attention in q's dtype, as ``repro.kernels.flash_attention.ops``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _build.kernel_device(q, k, v) == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, softcap=softcap,
                                   window=window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch(q, k, v, out, scale=scale, softcap=softcap, window=window)
    return out
