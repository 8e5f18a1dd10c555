"""Causal GQA flash attention (B8): the plain version on the CPU, one of
three CUDA kernels on the card.

q and k are (B, H, S, D), v and out (B, H, S, Dv): MLA's values are
narrower than its queries and keys.  ``kernel_route(dtype, d, dv)``
chooses the kernel by dtype and the two widths: bfloat16 at a (D, Dv) in
``WGMMA_DV`` runs the tensor-core kernel of ``csrc/flash_attention_wgmma.cu``
(``launch_wgmma``, counted under ``LAUNCHES["flash_attention_wgmma"]``);
float32 at D = Dv in ``TF32_D`` its float32 counterpart in three TF32
products, ``csrc/flash_attention_tf32.cu`` (``launch_tf32``,
``LAUNCHES["flash_attention_tf32"]``); every other dtype and pair the SIMT
kernel of ``csrc/flash_attention.cu`` (``launch_simt``,
``LAUNCHES["flash_attention_simt"]``), which takes D and Dv from 8 to 256
in steps of 8: float32 at the other widths, and bfloat16 at the pairs
outside ``WGMMA_DV`` (D 96, say, or D != Dv but MLA's).  None stands in
for another: a tensor that the chosen kernel does not take raises.

``launch_bwd`` runs B8's backward (``csrc/flash_attention_bwd.cu``: three
SIMT kernels, float32 and bfloat16, D and Dv 8..256 in steps of 8), the
gradients of every route's forward; it counts one launch a call under
``LAUNCHES["flash_attention_bwd"]``.  Its plain version is
``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# MusicGen-large, Zamba2-2.7B's shared block, Qwen2-7B, Gemma2-2b
WGMMA_D = (64, 80, 128, 256)
# the (D, Dv) pairs of the tensor-core kernel: D = Dv in WGMMA_D, and
# DeepSeek-V2's MLA prefill (q and k of 128 + 64, v of 128)
WGMMA_DV = tuple((d, d) for d in WGMMA_D) + ((192, 128),)
TF32_D = (64, 128)           # MusicGen-large, Qwen2-7B (D = Dv)
# TMA reads q, k and v by 16-byte strides from 16-byte aligned addresses;
# out is held to the same
_TMA_ALIGN = 16


class _FlashArgs(ctypes.Structure):
    """Field for field the ``FlashArgs`` struct of csrc/flash_attention.cuh."""
    _fields_ = [
        ("q", _P), ("k", _P), ("v", _P), ("o", _P),
        ("q_st", _I64 * 3), ("k_st", _I64 * 3), ("v_st", _I64 * 3),
        ("o_st", _I64 * 3),
        ("b", _I), ("hq", _I), ("hkv", _I), ("s", _I), ("d", _I),
        ("dv", _I), ("window", _I), ("scale", _F), ("softcap", _F),
        ("bf16", _I),
    ]


def kernel_route(dtype: torch.dtype, d: int, dv: int | None = None) -> str:
    """'wgmma', 'tf32' or 'simt': the kernel that a CUDA tensor of this
    dtype, q / k width D and v width Dv (default D) launches."""
    dv = d if dv is None else dv
    if dtype == torch.bfloat16 and (d, dv) in WGMMA_DV:
        return "wgmma"
    if dtype == torch.float32 and d == dv and d in TF32_D:
        return "tf32"
    return "simt"


def _check_common(q, k, v, out):
    req = _build.require
    b, hq, s, d = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    req(q.dtype in _DTYPES, f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t, h, w in (("k", k, hkv, d), ("v", v, hkv, dv),
                          ("out", out, hq, dv)):
        req(t.dtype == q.dtype, f"{name} must have q's dtype {q.dtype}")
        req(tuple(t.shape) == (b, h, s, w),
            f"{name} must be ({b}, {h}, {s}, {w}), got {tuple(t.shape)}")
    req(hkv >= 1 and hq % hkv == 0, f"Hq = {hq} must be a multiple of Hkv = {hkv}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        req(t.stride(3) == 1, f"{name} must have a unit stride over D")


def _run(entry: str, q, k, v, out, scale, softcap, window) -> None:
    b, hq, s, d = q.shape
    a = _FlashArgs(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                   o=out.data_ptr(), b=b, hq=hq, hkv=k.shape[1], s=s, d=d,
                   dv=v.shape[3], window=int(window), scale=float(scale),
                   softcap=float(softcap), bf16=_DTYPES[q.dtype])
    for field, t in (("q_st", q), ("k_st", k), ("v_st", v), ("o_st", out)):
        getattr(a, field)[:] = t.stride()[:3]
    with torch.cuda.device(q.device):
        _build.call(entry, [ctypes.POINTER(_FlashArgs), _P],
                    ctypes.byref(a), _build.stream_of(q))


def launch_simt(q, k, v, out, *, scale: float, softcap: float = 0.0,
                window: int = 0) -> None:
    """B8's SIMT kernel into ``out``: float32 or bfloat16, D and Dv each
    from 8 to 256 in steps of 8.  All four are (B, H, S, width) views on
    one card, any (b, h, s) strides with a unit last stride: q (B, Hq, S,
    D), k (B, Hkv, S, D), v (B, Hkv, S, Dv) and out (B, Hq, S, Dv)."""
    _check_common(q, k, v, out)
    for name, w in (("D", q.shape[3]), ("Dv", v.shape[3])):
        _build.require(8 <= w <= 256 and w % 8 == 0,
                       f"{name} = {w}: the SIMT kernel takes 8..256 in "
                       "steps of 8")
    _run("repro_flash_attention_simt", q, k, v, out, scale, softcap, window)
    LAUNCHES["flash_attention_simt"] += 1


def _check_tma(q, k, v, out) -> None:
    """What TMA reads and the tensor-core kernels store through: (b, h, s)
    strides of a multiple of 16 bytes and data starting on 16 bytes."""
    req = _build.require
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        nbytes = t.element_size()
        req(all(st * nbytes % _TMA_ALIGN == 0 for st in t.stride()[:3]),
            f"{name} strides {t.stride()}: TMA needs (b, h, s) strides of a "
            f"multiple of {_TMA_ALIGN} bytes")
        req(t.data_ptr() % _TMA_ALIGN == 0,
            f"{name} must start on a {_TMA_ALIGN}-byte boundary for TMA")


def launch_wgmma(q, k, v, out, *, scale: float, softcap: float = 0.0,
                 window: int = 0) -> None:
    """B8's tensor-core kernel into ``out``: bfloat16, (D, Dv) in
    ``WGMMA_DV``, views as for ``launch_simt`` whose (b, h, s) strides are
    multiples of 16 bytes and whose data start on 16 bytes (what TMA
    reads)."""
    _check_common(q, k, v, out)
    req = _build.require
    d, dv = q.shape[3], v.shape[3]
    req(q.dtype == torch.bfloat16,
        f"the tensor-core kernel takes bfloat16, got {q.dtype}")
    req((d, dv) in WGMMA_DV, f"(D, Dv) = ({d}, {dv}): the tensor-core "
        f"kernel takes {WGMMA_DV}")
    _check_tma(q, k, v, out)
    _run("repro_flash_attention_wgmma", q, k, v, out, scale, softcap, window)
    LAUNCHES["flash_attention_wgmma"] += 1


def launch_tf32(q, k, v, out, *, scale: float, softcap: float = 0.0,
                window: int = 0) -> None:
    """B8's float32 tensor-core kernel (3xTF32) into ``out``: float32, D =
    Dv in ``TF32_D``, views with TMA's strides and alignment as for
    ``launch_wgmma``."""
    _check_common(q, k, v, out)
    req = _build.require
    d, dv = q.shape[3], v.shape[3]
    req(q.dtype == torch.float32,
        f"the float32 tensor-core kernel takes float32, got {q.dtype}")
    req(d == dv and d in TF32_D, f"(D, Dv) = ({d}, {dv}): the float32 "
        f"tensor-core kernel takes D = Dv in {TF32_D}")
    _check_tma(q, k, v, out)
    _run("repro_flash_attention_tf32", q, k, v, out, scale, softcap, window)
    LAUNCHES["flash_attention_tf32"] += 1


def launch(q, k, v, out, *, scale: float, softcap: float = 0.0,
           window: int = 0) -> None:
    """Run B8 into ``out`` through the kernel ``kernel_route`` names for
    q's dtype, D and v's Dv."""
    fn = {"wgmma": launch_wgmma, "tf32": launch_tf32,
          "simt": launch_simt}[kernel_route(q.dtype, q.shape[3], v.shape[3])]
    fn(q, k, v, out, scale=scale, softcap=softcap, window=window)


class _FlashBwdArgs(ctypes.Structure):
    """Field for field the ``FlashBwdArgs`` struct of
    csrc/flash_attention_bwd.cu."""
    _fields_ = [
        ("q", _P), ("k", _P), ("v", _P), ("o", _P), ("g_o", _P),
        ("g_q", _P), ("g_k", _P), ("g_v", _P), ("lse", _P), ("delta", _P),
        ("q_st", _I64 * 3), ("k_st", _I64 * 3), ("v_st", _I64 * 3),
        ("o_st", _I64 * 3), ("go_st", _I64 * 3), ("gq_st", _I64 * 3),
        ("gk_st", _I64 * 3), ("gv_st", _I64 * 3),
        ("b", _I), ("hq", _I), ("hkv", _I), ("s", _I), ("d", _I),
        ("dv", _I), ("window", _I), ("scale", _F), ("softcap", _F),
        ("bf16", _I),
    ]


def launch_bwd(q, k, v, out, dout, *, scale: float, softcap: float = 0.0,
               window: int = 0):
    """B8's backward kernel: the gradients of q, k and v, given the
    forward's ``out`` and the gradient ``dout`` that reaches it.

    q (B, Hq, S, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv), out and dout (B,
    Hq, S, Dv): float32 or bfloat16 views on one card with a unit last
    stride, any (b, h, s) strides; D and Dv each 8..256 in steps of 8.
    Returns (dq, dk, dv) laid out as q, k and v (``torch.empty_like``) in
    their dtype.  Everything else raises before any launch."""
    _check_common(q, k, v, out)
    req = _build.require
    b, hq, s, d = q.shape
    dv = v.shape[3]
    req(dout.dtype == q.dtype, f"dout must have q's dtype {q.dtype}")
    req(tuple(dout.shape) == (b, hq, s, dv),
        f"dout must be ({b}, {hq}, {s}, {dv}), got {tuple(dout.shape)}")
    req(dout.stride(3) == 1, "dout must have a unit stride over Dv")
    for name, w in (("D", d), ("Dv", dv)):
        req(8 <= w <= 256 and w % 8 == 0,
            f"{name} = {w}: B8's backward takes 8..256 in steps of 8")
    req(_build.kernel_device(q, k, v, out, dout) == "cuda",
        "B8's backward runs on one CUDA device")
    g_q, g_k, g_v = (torch.empty_like(t) for t in (q, k, v))
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    _run_bwd((q, k, v, out, dout, g_q, g_k, g_v), lse,
             torch.empty_like(lse), scale, softcap, window)
    LAUNCHES["flash_attention_bwd"] += 1
    return g_q, g_k, g_v


def _run_bwd(tensors, lse, delta, scale, softcap, window) -> None:
    """The C call of ``launch_bwd`` on (q, k, v, out, dout, dq, dk, dv)
    and the (B, Hq, S) float32 scratch."""
    q, k, v = tensors[:3]
    b, hq, s, d = q.shape
    a = _FlashBwdArgs(
        lse=lse.data_ptr(), delta=delta.data_ptr(), b=b, hq=hq,
        hkv=k.shape[1], s=s, d=d, dv=v.shape[3], window=int(window),
        scale=float(scale), softcap=float(softcap), bf16=_DTYPES[q.dtype])
    for (ptr, st), t in zip((("q", "q_st"), ("k", "k_st"), ("v", "v_st"),
                             ("o", "o_st"), ("g_o", "go_st"),
                             ("g_q", "gq_st"), ("g_k", "gk_st"),
                             ("g_v", "gv_st")), tensors):
        setattr(a, ptr, t.data_ptr())
        getattr(a, st)[:] = t.stride()[:3]
    with torch.cuda.device(q.device):
        _build.call("repro_flash_attention_bwd",
                    [ctypes.POINTER(_FlashBwdArgs), _P], ctypes.byref(a),
                    _build.stream_of(q))


def flash_attention(q, k, v, *, scale: float | None = None,
                    softcap: float = 0.0, window: int = 0):
    """q (B, Hq, S, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv) -> (B, Hq, S,
    Dv) causal GQA attention in q's dtype, as
    ``repro.kernels.flash_attention.ops`` (which takes Dv = D only)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _build.kernel_device(q, k, v) == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, softcap=softcap,
                                   window=window)
    out = torch.empty((*q.shape[:3], v.shape[3]), dtype=q.dtype,
                      device=q.device)
    launch(q, k, v, out, scale=scale, softcap=softcap, window=window)
    return out
