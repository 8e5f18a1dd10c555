"""Neighbour-embedding forces: scatter-fused (B3), index-taking with per-edge
output (B5) and pre-gathered (B7).  Plain versions on the CPU, the CUDA
kernels of ``csrc/ne_forces.cu`` on the card.

B5 and B7 run one of three routes (``edges_route``):

- rounds: d <= ``ROUNDS_MAX_D``; a warp runs a row's rounds (B3's plan:
  two segments of at most 16 edges share a round on the half-warps), or
  two rows of one such segment;
- staged: d in ``STAGED_WIDTHS`` with the neighbour rows on 16 bytes; the
  same rounds, with each chunk of 32 neighbour rows and edges passed
  through shared memory;
- warp: every other row; one warp per row.

Each route counts its launches under its own key (``ne_forces_rounds``,
``ne_forces_staged``, ``ne_forces_gather_rounds``,
``ne_forces_gather_staged``; the warp route ``ne_forces`` and
``ne_forces_gather``).  Their outputs agree bit for bit.  The C entries
refuse a width or a row they do not take.

All three run under ``fallback.guarded`` of the family "ne_forces", as
their JAX counterparts do: a pass-through unless a caller opts in."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.ne_forces.ref import (
    ne_forces_gather_ref, ne_forces_ref, ne_forces_scatter_ref)

_MAX_SEG = 4
_MODES = {"attraction": 0, "repulsion": 1}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FAMILY = "ne_forces"


# the routes of B5 and B7 by width (csrc/ne_forces.cu: kRoundsMaxD and the
# staged entry's cases): the staged route at the widths the flag paths run
# past the rounds route's
ROUNDS_MAX_D = 4
STAGED_WIDTHS = (8, 32)


def edges_route(d, aligned=True):
    """The route of B5 and B7 at width ``d``: "rounds" when d <=
    ROUNDS_MAX_D, "staged" when d is in STAGED_WIDTHS and the neighbour
    rows' source is ``aligned`` on 16 bytes, else "warp"."""
    if d <= ROUNDS_MAX_D:
        return "rounds"
    return "staged" if d in STAGED_WIDTHS and aligned else "warp"


class _ForceArgs(ctypes.Structure):
    """Field for field the ``ForceArgs`` struct of csrc/ne_forces.cu."""
    _fields_ = [
        ("y", _P), ("n", _I64), ("qid", _P), ("b", _I64), ("nbr", _P),
        ("coef", _P), ("alpha", _P), ("wsum", _P), ("agg", _P),
        ("max_bits", _P), ("acc", _P), ("out", _P), ("k", _I),
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


def _run(entry, a, d, like):
    """Call the C entry ``entry`` with the argument block ``a`` and width
    ``d`` on ``like``'s card and current stream."""
    with torch.cuda.device(like.device):
        _build.call(entry, [ctypes.POINTER(type(a)), _I, _P],
                    ctypes.byref(a), d, _build.stream_of(like))


def _launch_edges(a, segments, edges, d, src, key):
    """Fill B5's or B7's argument block, launch the route of width ``d``
    and of the neighbour rows' source ``src`` and count it under ``key``
    (the warp route's) or ``key_<route>``."""
    k0 = 0
    for i, (mode, size) in enumerate(segments):
        a.seg_start[i], a.seg_size[i] = k0, size
        a.seg_mode[i] = _MODES[mode]
        a.edge[i] = None if edges[i] is None else edges[i].data_ptr()
        k0 += size
    route = edges_route(d, src.data_ptr() % 16 == 0)
    entry = "repro_ne_forces_edges"
    if route != "warp":
        entry, key = f"{entry}_{route}", f"{key}_{route}"
    _run(entry, a, d, src)
    LAUNCHES[key] += 1


def ne_forces(y, nbr, coef, alpha, *, mode: str):
    """Pre-gathered forces of one mode (B7).

    Args:
      y: (B, d) f32 query rows; nbr: (B, K, d) f32 neighbour rows;
      coef: (B, K) f32 edge coefficients; alpha: f32 scalar tensor.
    Returns (agg (B, d), edge (B, K, d), wsum (B,)), as
    ``repro.kernels.ne_forces.ops.ne_forces``.
    """
    segments = _check_segments(((mode, nbr.shape[1]),), nbr.shape[1])
    ref = functools.partial(ne_forces_ref, y, nbr, coef, alpha, mode=mode)
    if _build.kernel_device(y, nbr, coef, alpha) == "cpu":
        return _build.guarded(_FAMILY, None, ref)
    b, d = y.shape
    k = nbr.shape[1]
    req = _build.require
    req(y.dtype == torch.float32 and y.ndim == 2 and y.is_contiguous(),
        "y must be a contiguous (B, d) float32 tensor")
    req(nbr.dtype == torch.float32 and nbr.shape == (b, k, d)
        and nbr.is_contiguous(), "nbr must be a contiguous (B, K, d) float32")
    _check_common(coef, alpha, b, k, d, 1)

    def launch():
        dev = y.device
        agg = torch.empty((1, b, d), dtype=torch.float32, device=dev)
        edge = torch.empty((b, k, d), dtype=torch.float32, device=dev)
        wsum = torch.empty((1, b), dtype=torch.float32, device=dev)
        a = _EdgeArgs(y=y.data_ptr(), nbr=nbr.data_ptr(),
                      coef=coef.data_ptr(), alpha=alpha.data_ptr(), b=b, k=k,
                      n_seg=1, agg=agg.data_ptr(), wsum=wsum.data_ptr())
        _launch_edges(a, segments, (edge,), d, nbr, "ne_forces")
        return agg[0], edge, wsum[0]
    return _build.guarded(_FAMILY, launch)


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
    ref = functools.partial(ne_forces_gather_ref, x, qid, nbr_idx, coef,
                            alpha, segments=segments, emit_edges=emit_edges)
    if _build.kernel_device(x, qid, nbr_idx, coef, alpha) == "cpu":
        return _build.guarded(_FAMILY, None, ref)
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

    def launch():
        dev = x.device
        aggs = torch.empty((s, b, d), dtype=torch.float32, device=dev)
        wsums = torch.empty((s, b), dtype=torch.float32, device=dev)
        edges = tuple(
            torch.empty((b, size, d), dtype=torch.float32, device=dev)
            if emit else None
            for (_, size), emit in zip(segments, emit_edges))
        a = _EdgeArgs(x=x.data_ptr(), n=n, qid=qid.data_ptr(),
                      nbr_idx=nbr_idx.data_ptr(), coef=coef.data_ptr(),
                      alpha=alpha.data_ptr(), b=b, k=k, n_seg=s,
                      agg=aggs.data_ptr(), wsum=wsums.data_ptr())
        _launch_edges(a, segments, edges, d, x, "ne_forces_gather")
        return tuple(aggs.unbind(0)), edges, tuple(wsums.unbind(0))
    return _build.guarded(_FAMILY, launch)


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
    ref = functools.partial(ne_forces_scatter_ref, x, qid, nbr_idx, coef,
                            alpha, segments=segments,
                            scatter_back=scatter_back)
    if _build.kernel_device(x, qid, nbr_idx, coef, alpha) == "cpu":
        return _build.guarded(_FAMILY, None, ref)
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
    return _build.guarded(_FAMILY, functools.partial(
        _launch_scatter, x, qid, nbr_idx, coef, alpha, segments,
        scatter_back))


def _launch_scatter(x, qid, nbr_idx, coef, alpha, segments, scatter_back):
    """B3's launch on checked inputs: its outputs and one launch."""
    n, d = x.shape
    b, k = nbr_idx.shape
    s = len(segments)
    # two allocations: floats (the fields, the wsums, each row's aggregate)
    # and int64 (the fixed-point fields, then S + 2 flag words)
    dev = x.device
    f32 = torch.empty(s * (n * d + b + b * d), dtype=torch.float32,
                      device=dev)
    i64 = torch.empty(s * n * d + (s + 3) // 2, dtype=torch.int64, device=dev)
    out = f32[:s * n * d].view(s, n, d)
    wsum = f32[s * n * d:s * (n * d + b)].view(s, b)
    a = _ForceArgs(y=x.data_ptr(), n=n, qid=qid.data_ptr(), b=b,
                   nbr=nbr_idx.data_ptr(), coef=coef.data_ptr(),
                   alpha=alpha.data_ptr(), wsum=wsum.data_ptr(),
                   agg=f32[s * (n * d + b):].data_ptr(),
                   max_bits=i64[s * n * d:].data_ptr(), acc=i64.data_ptr(),
                   out=out.data_ptr(), k=k, n_seg=s)
    k0 = 0
    for i, ((mode, size), back) in enumerate(zip(segments, scatter_back)):
        a.seg_start[i], a.seg_size[i] = k0, size
        a.seg_mode[i], a.seg_back[i] = _MODES[mode], int(back)
        k0 += size
    _run("repro_ne_forces_scatter", a, d, x)
    LAUNCHES["ne_forces_scatter"] += 1
    return tuple(out.unbind(0)), tuple(wsum.unbind(0))
