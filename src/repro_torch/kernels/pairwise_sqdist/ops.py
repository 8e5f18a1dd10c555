"""Squared distances, gathered (B1) and pre-gathered (B6): plain versions on
the CPU, the CUDA kernels of ``csrc/pairwise_sqdist.cu`` on the card.

B1 runs one of three routes, chosen by the row width (``gather_route``),
with the bounds of B2/B4's routes (``knn_merge.ops``):

- lanes: rows of at most ``LANE_M`` floats (the LD lists), one thread per
  (query, candidate) pair;
- ring: rows of ``RING_MIN_M`` to ``RING_MAX_M`` floats with M % 4 == 0 on
  a 16-byte-aligned x (MNIST's 784), one warp per query row with a ring of
  whole candidate rows in shared memory (the kernel's launcher sizes it);
- warp: the rest (16, 32, 783 columns, a misaligned x), one warp per pair.

Each route counts its launches under its own key
(``pairwise_sqdist_gather_lanes``, ``pairwise_sqdist_gather_ring``; the
warp route ``pairwise_sqdist_gather``).  Their distances agree bit for
bit.

Both run under ``fallback.guarded`` of the family "pairwise_sqdist", as
their JAX counterparts do: a pass-through unless a caller opts in."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.knn_merge.ops import LANE_M, RING_MAX_M, RING_MIN_M
from repro_torch.kernels.pairwise_sqdist.ref import (
    pairwise_sqdist_gather_ref, pairwise_sqdist_ref)

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = [_P, _I64, _I64, _P, _P, _I64, _I64, _P, _P]
_ARGTYPES_PRE = [_P, _P, _I64, _I64, _I64, _P, _P]
_FAMILY = "pairwise_sqdist"


def gather_route(m, aligned=True):
    """The route of B1 over rows of ``m`` floats (``aligned``: x starts on
    16 bytes): "lanes" when m <= LANE_M; "ring" when ``aligned``, m % 4 ==
    0 and RING_MIN_M <= m <= RING_MAX_M; else "warp"."""
    if m <= LANE_M:
        return "lanes"
    if aligned and m % 4 == 0 and RING_MIN_M <= m <= RING_MAX_M:
        return "ring"
    return "warp"


def _run(entry, x, qid, cand, out):
    n, m = x.shape
    b, c = cand.shape
    with torch.cuda.device(x.device):
        _build.call(entry, _ARGTYPES, x.data_ptr(), n, m, qid.data_ptr(),
                    cand.data_ptr(), b, c, out.data_ptr(), _build.stream_of(x))


def pairwise_sqdist_gather(x, qid, cand):
    """(N, M) f32, (B,) i32, (B, C) i32 -> (B, C) f32 squared distances
    ``||x[clip(qid[b])] - x[clip(cand[b, j])]||^2``."""
    ref = functools.partial(pairwise_sqdist_gather_ref, x, qid, cand)
    if _build.kernel_device(x, qid, cand) == "cpu":
        return _build.guarded(_FAMILY, None, ref)
    req = _build.require
    req(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous(),
        "x must be a contiguous (N, M) float32 tensor")
    req(qid.dtype == torch.int32 and qid.ndim == 1 and qid.is_contiguous(),
        "qid must be a contiguous (B,) int32 tensor")
    req(cand.dtype == torch.int32 and cand.ndim == 2 and cand.is_contiguous()
        and cand.shape[0] == qid.shape[0],
        "cand must be a contiguous (B, C) int32 tensor")
    route = gather_route(x.shape[1], x.data_ptr() % 16 == 0)
    key = "pairwise_sqdist_gather" + ("" if route == "warp" else f"_{route}")

    def launch():
        out = torch.empty(cand.shape, dtype=torch.float32, device=x.device)
        _run(f"repro_{key}", x, qid, cand, out)
        LAUNCHES[key] += 1
        return out
    return _build.guarded(_FAMILY, launch)


def pairwise_sqdist(q, c):
    """(B, M) f32, (B, C, M) f32 -> (B, C) f32 ``||q[b] - c[b, j]||^2``."""
    ref = functools.partial(pairwise_sqdist_ref, q, c)
    if _build.kernel_device(q, c) == "cpu":
        return _build.guarded(_FAMILY, None, ref)
    req = _build.require
    req(q.dtype == torch.float32 and q.ndim == 2 and q.is_contiguous(),
        "q must be a contiguous (B, M) float32 tensor")
    b, m = q.shape
    req(c.dtype == torch.float32 and c.ndim == 3 and c.is_contiguous()
        and c.shape[0] == b and c.shape[2] == m,
        "c must be a contiguous (B, C, M) float32 tensor")
    cc = c.shape[1]

    def launch():
        out = torch.empty((b, cc), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            _build.call("repro_pairwise_sqdist", _ARGTYPES_PRE, q.data_ptr(),
                        c.data_ptr(), b, cc, m, out.data_ptr(),
                        _build.stream_of(q))
        LAUNCHES["pairwise_sqdist"] += 1
        return out
    return _build.guarded(_FAMILY, launch)
