"""Neighbour-embedding forces: scatter-fused (B3), index-taking with per-edge
output (B5) and pre-gathered (B7).  Plain versions on the CPU, the CUDA
kernels of ``csrc/ne_forces.cu`` on the card."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ne_forces.ref import (
    ne_forces_gather_ref, ne_forces_ref, ne_forces_scatter_ref)

_MAX_SEG = 4
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


class _EdgeArgs(ctypes.Structure):
    """Field for field the ``EdgeArgs`` struct of csrc/ne_forces.cu."""
    _fields_ = [
        ("x", _P), ("n", _I64), ("qid", _P), ("nbr_idx", _P), ("y", _P),
        ("nbr", _P), ("coef", _P), ("alpha", _P), ("b", _I64), ("k", _I),
        ("n_seg", _I), ("seg_start", _I * _MAX_SEG),
        ("seg_size", _I * _MAX_SEG), ("seg_mode", _I * _MAX_SEG),
        ("edge", _P * _MAX_SEG), ("agg", _P), ("wsum", _P),
    ]


def _check_segments(segments, k):
    segments = tuple((str(mode), int(size)) for mode, size in segments)
    req = _build.require
    req(all(mode in _MODES and size > 0 for mode, size in segments),
        f"segments must be (mode in {sorted(_MODES)}, size > 0) pairs")
    req(k == sum(size for _, size in segments),
        "segment sizes must add up to the neighbour axis")
    return segments


def _check_common(coef, alpha, b, k, d, s):
    """The kernels' input checks shared by B3, B5 and B7."""
    req = _build.require
    req(d >= 1, "d must be >= 1")
    req(s <= _MAX_SEG, f"at most {_MAX_SEG} segments")
    req(coef.dtype == torch.float32 and coef.shape == (b, k)
        and coef.is_contiguous(), "coef must be a contiguous (B, K) float32")
    req(alpha.dtype == torch.float32 and alpha.numel() == 1,
        "alpha must be a float32 scalar tensor")


def _launch_edges(a, segments, edges, d, like):
    k0 = 0
    for i, (mode, size) in enumerate(segments):
        a.seg_start[i], a.seg_size[i] = k0, size
        a.seg_mode[i] = _MODES[mode]
        a.edge[i] = None if edges[i] is None else edges[i].data_ptr()
        k0 += size
    with torch.cuda.device(like.device):
        _build.call("repro_ne_forces_edges",
                    [ctypes.POINTER(_EdgeArgs), _I, _P], ctypes.byref(a), d,
                    _build.stream_of(like))


def ne_forces(y, nbr, coef, alpha, *, mode: str):
    """Pre-gathered forces of one mode (B7).

    Args:
      y: (B, d) f32 query rows; nbr: (B, K, d) f32 neighbour rows;
      coef: (B, K) f32 edge coefficients; alpha: f32 scalar tensor.
    Returns (agg (B, d), edge (B, K, d), wsum (B,)), as
    ``repro.kernels.ne_forces.ops.ne_forces``.
    """
    segments = _check_segments(((mode, nbr.shape[1]),), nbr.shape[1])
    if _build.kernel_device(y, nbr, coef, alpha) == "cpu":
        return ne_forces_ref(y, nbr, coef, alpha, mode=mode)
    b, d = y.shape
    k = nbr.shape[1]
    req = _build.require
    req(y.dtype == torch.float32 and y.ndim == 2 and y.is_contiguous(),
        "y must be a contiguous (B, d) float32 tensor")
    req(nbr.dtype == torch.float32 and nbr.shape == (b, k, d)
        and nbr.is_contiguous(), "nbr must be a contiguous (B, K, d) float32")
    _check_common(coef, alpha, b, k, d, 1)
    dev = y.device
    agg = torch.empty((1, b, d), dtype=torch.float32, device=dev)
    edge = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    wsum = torch.empty((1, b), dtype=torch.float32, device=dev)
    a = _EdgeArgs(y=y.data_ptr(), nbr=nbr.data_ptr(), coef=coef.data_ptr(),
                  alpha=alpha.data_ptr(), b=b, k=k, n_seg=1,
                  agg=agg.data_ptr(), wsum=wsum.data_ptr())
    _launch_edges(a, segments, (edge,), d, y)
    LAUNCHES["ne_forces"] += 1
    return agg[0], edge, wsum[0]


def ne_forces_gather(x, qid, nbr_idx, coef, alpha, *, segments, emit_edges):
    """Index-taking segmented forces with per-edge output (B5).

    Args as :func:`ne_forces_scatter`; ``emit_edges`` are per-segment bools.
    Returns per-segment tuples (aggs (B, d), edges (B, K_s, d) or None
    where the segment does not emit, wsums (B,)), as
    ``repro.kernels.ne_forces.ops.ne_forces_gather`` in edge mode.
    """
    segments = _check_segments(segments, nbr_idx.shape[1])
    emit_edges = tuple(bool(e) for e in emit_edges)
    _build.require(len(emit_edges) == len(segments), "one emit_edges per segment")
    if _build.kernel_device(x, qid, nbr_idx, coef, alpha) == "cpu":
        return ne_forces_gather_ref(x, qid, nbr_idx, coef, alpha,
                                    segments=segments, emit_edges=emit_edges)
    n, d = x.shape
    b, k = nbr_idx.shape
    s = len(segments)
    req = _build.require
    req(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous(),
        "x must be a contiguous (N, d) float32 tensor")
    req(qid.dtype == torch.int32 and qid.shape == (b,) and qid.is_contiguous(),
        "qid must be a contiguous (B,) int32 tensor")
    req(nbr_idx.dtype == torch.int32 and nbr_idx.is_contiguous(),
        "nbr_idx must be a contiguous (B, K) int32 tensor")
    _check_common(coef, alpha, b, k, d, s)
    dev = x.device
    aggs = torch.empty((s, b, d), dtype=torch.float32, device=dev)
    wsums = torch.empty((s, b), dtype=torch.float32, device=dev)
    edges = tuple(torch.empty((b, size, d), dtype=torch.float32, device=dev)
                  if emit else None
                  for (_, size), emit in zip(segments, emit_edges))
    a = _EdgeArgs(x=x.data_ptr(), n=n, qid=qid.data_ptr(),
                  nbr_idx=nbr_idx.data_ptr(), coef=coef.data_ptr(),
                  alpha=alpha.data_ptr(), b=b, k=k, n_seg=s,
                  agg=aggs.data_ptr(), wsum=wsums.data_ptr())
    _launch_edges(a, segments, edges, d, x)
    LAUNCHES["ne_forces_gather"] += 1
    return tuple(aggs.unbind(0)), edges, tuple(wsums.unbind(0))


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
    segments = _check_segments(segments, nbr_idx.shape[1])
    if scatter_back is None:
        scatter_back = (True,) * len(segments)
    scatter_back = tuple(bool(v) for v in scatter_back)
    req = _build.require
    req(len(scatter_back) == len(segments), "one scatter_back per segment")
    if _build.kernel_device(x, qid, nbr_idx, coef, alpha) == "cpu":
        return ne_forces_scatter_ref(x, qid, nbr_idx, coef, alpha,
                                     segments=segments,
                                     scatter_back=scatter_back)
    n, d = x.shape
    b, k = nbr_idx.shape
    s = len(segments)
    req(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous(),
        "x must be a contiguous (N, d) float32 tensor")
    req(qid.dtype == torch.int32 and qid.shape == (b,) and qid.is_contiguous(),
        "qid must be a contiguous (B,) int32 tensor")
    req(nbr_idx.dtype == torch.int32 and nbr_idx.is_contiguous(),
        "nbr_idx must be a contiguous (B, K) int32 tensor")
    _check_common(coef, alpha, b, k, d, s)

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
