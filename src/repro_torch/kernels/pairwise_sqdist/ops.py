"""Squared distances, gathered (B1) and pre-gathered (B6): plain versions on
the CPU, the CUDA kernels of ``csrc/pairwise_sqdist.cu`` on the card."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.pairwise_sqdist.ref import (
    pairwise_sqdist_gather_ref, pairwise_sqdist_ref)

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = [_P, _I64, _I64, _P, _P, _I64, _I64, _P, _P]
_ARGTYPES_PRE = [_P, _P, _I64, _I64, _I64, _P, _P]


def pairwise_sqdist_gather(x, qid, cand):
    """(N, M) f32, (B,) i32, (B, C) i32 -> (B, C) f32 squared distances
    ``||x[clip(qid[b])] - x[clip(cand[b, j])]||^2``."""
    if _build.kernel_device(x, qid, cand) == "cpu":
        return pairwise_sqdist_gather_ref(x, qid, cand)
    req = _build.require
    req(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous(),
        "x must be a contiguous (N, M) float32 tensor")
    req(qid.dtype == torch.int32 and qid.ndim == 1 and qid.is_contiguous(),
        "qid must be a contiguous (B,) int32 tensor")
    req(cand.dtype == torch.int32 and cand.ndim == 2 and cand.is_contiguous()
        and cand.shape[0] == qid.shape[0],
        "cand must be a contiguous (B, C) int32 tensor")
    n, m = x.shape
    b, c = cand.shape
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.call("repro_pairwise_sqdist_gather", _ARGTYPES,
                    x.data_ptr(), n, m, qid.data_ptr(), cand.data_ptr(), b, c,
                    out.data_ptr(), _build.stream_of(x))
    LAUNCHES["pairwise_sqdist_gather"] += 1
    return out


def pairwise_sqdist(q, c):
    """(B, M) f32, (B, C, M) f32 -> (B, C) f32 ``||q[b] - c[b, j]||^2``."""
    if _build.kernel_device(q, c) == "cpu":
        return pairwise_sqdist_ref(q, c)
    req = _build.require
    req(q.dtype == torch.float32 and q.ndim == 2 and q.is_contiguous(),
        "q must be a contiguous (B, M) float32 tensor")
    b, m = q.shape
    req(c.dtype == torch.float32 and c.ndim == 3 and c.is_contiguous()
        and c.shape[0] == b and c.shape[2] == m,
        "c must be a contiguous (B, C, M) float32 tensor")
    cc = c.shape[1]
    out = torch.empty((b, cc), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.call("repro_pairwise_sqdist", _ARGTYPES_PRE, q.data_ptr(),
                    c.data_ptr(), b, cc, m, out.data_ptr(),
                    _build.stream_of(q))
    LAUNCHES["pairwise_sqdist"] += 1
    return out
