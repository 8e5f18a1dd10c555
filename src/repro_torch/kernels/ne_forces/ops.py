"""Scatter-fused forces (B3): plain version on the CPU, the CUDA kernel
``csrc/ne_forces.cu`` on the card."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ne_forces.ref import ne_forces_scatter_ref

_MAX_SEG, _MAX_D = 4, 4
_MODES = {"attraction": 0, "repulsion": 1}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


class _ForceArgs(ctypes.Structure):
    """Field for field the ``ForceArgs`` struct of csrc/ne_forces.cu."""
    _fields_ = [
        ("y", _P), ("n", _I64), ("qid", _P), ("b", _I64), ("nbr", _P),
        ("coef", _P), ("alpha", _P), ("wsum", _P), ("max_bits", _P),
        ("nonfinite", _P), ("acc", _P), ("out", _P), ("k", _I),
        ("n_seg", _I), ("seg_start", _I * _MAX_SEG),
        ("seg_size", _I * _MAX_SEG), ("seg_mode", _I * _MAX_SEG),
        ("seg_back", _I * _MAX_SEG),
    ]


def ne_forces_scatter(x, qid, nbr_idx, coef, alpha, *, segments,
                      scatter_back=None):
    """Segmented variable-tail forces binned into per-segment fields.

    Args:
      x: (N, d) f32 embedding.
      qid: (B,) int32 rows the forces act on.
      nbr_idx: (B, K) int32 neighbour ids (clipped to [0, N)).
      coef: (B, K) f32 edge coefficients (0 masks an edge).
      alpha: f32 tail parameter (a 0-dim tensor on x's device).
      segments: static ((mode, size), ...) partition of the K axis.
      scatter_back: per-segment bools (default all True).
    Returns (scats, wsums): tuples of (N, d) f32 fields and (B,) f32 sums.
    The CUDA kernel is deterministic (fixed-point accumulation, see its
    source), so two launches on the same inputs agree bit for bit.
    """
    segments = tuple((str(mode), int(size)) for mode, size in segments)
    if scatter_back is None:
        scatter_back = (True,) * len(segments)
    scatter_back = tuple(bool(v) for v in scatter_back)
    req = _build.require
    req(len(scatter_back) == len(segments), "one scatter_back per segment")
    req(all(mode in _MODES and size > 0 for mode, size in segments),
        f"segments must be (mode in {sorted(_MODES)}, size > 0) pairs")
    req(nbr_idx.shape[1] == sum(size for _, size in segments),
        "segment sizes must add up to nbr_idx's width")
    if _build.kernel_device(x, qid, nbr_idx, coef, alpha) == "cpu":
        return ne_forces_scatter_ref(x, qid, nbr_idx, coef, alpha,
                                     segments=segments,
                                     scatter_back=scatter_back)
    n, d = x.shape
    b, k = nbr_idx.shape
    s = len(segments)
    req(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous()
        and 1 <= d <= _MAX_D, f"x must be contiguous (N, d<={_MAX_D}) float32")
    req(qid.dtype == torch.int32 and qid.shape == (b,) and qid.is_contiguous(),
        "qid must be a contiguous (B,) int32 tensor")
    req(nbr_idx.dtype == torch.int32 and nbr_idx.is_contiguous(),
        "nbr_idx must be a contiguous (B, K) int32 tensor")
    req(coef.dtype == torch.float32 and coef.shape == (b, k)
        and coef.is_contiguous(), "coef must be a contiguous (B, K) float32")
    req(alpha.dtype == torch.float32 and alpha.numel() == 1,
        "alpha must be a float32 scalar tensor")
    req(s <= _MAX_SEG, f"at most {_MAX_SEG} segments")

    dev = x.device
    wsum = torch.empty((s, b), dtype=torch.float32, device=dev)
    max_bits = torch.zeros((s,), dtype=torch.int32, device=dev)
    nonfinite = torch.zeros((1,), dtype=torch.int32, device=dev)
    acc = torch.zeros((s, n, d), dtype=torch.int64, device=dev)
    out = torch.empty((s, n, d), dtype=torch.float32, device=dev)
    a = _ForceArgs(y=x.data_ptr(), n=n, qid=qid.data_ptr(), b=b,
                   nbr=nbr_idx.data_ptr(), coef=coef.data_ptr(),
                   alpha=alpha.data_ptr(), wsum=wsum.data_ptr(),
                   max_bits=max_bits.data_ptr(),
                   nonfinite=nonfinite.data_ptr(), acc=acc.data_ptr(),
                   out=out.data_ptr(), k=k, n_seg=s)
    k0 = 0
    for i, ((mode, size), back) in enumerate(zip(segments, scatter_back)):
        a.seg_start[i], a.seg_size[i] = k0, size
        a.seg_mode[i], a.seg_back[i] = _MODES[mode], int(back)
        k0 += size
    with torch.cuda.device(dev):
        _build.call("repro_ne_forces_scatter",
                    [ctypes.POINTER(_ForceArgs), _I, _P], ctypes.byref(a), d,
                    _build.stream_of(x))
    LAUNCHES["ne_forces_scatter"] += 1
    return tuple(out.unbind(0)), tuple(wsum.unbind(0))
