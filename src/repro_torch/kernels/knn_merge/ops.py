"""Neighbour refinement on precomputed candidates (B4) and candidate-fused
(B2): plain versions on the CPU, the CUDA kernels of ``csrc/knn_merge.cu``
on the card.

Each runs one of three routes, chosen by shape (``merge_route``):

- lanes: rows of at most ``LANE_M`` floats with K + C <= 32 (FUnc-SNE's LD
  refinement), one lane per element of [current list, candidates];
- ring: rows of ``RING_MIN_M`` to ``RING_MAX_M`` floats with M % 4 == 0 on
  a 16-byte-aligned x (HD refinement and NND on MNIST's 784), one warp per
  query row with a ring of whole candidate rows in shared memory, filled by
  1-D bulk copies (the kernel's launcher sizes it; it fits at every K and C
  the kernels take);
- warp: the rest (other widths, long lists on narrow rows), one warp per
  query row scoring its candidate rows in turn.

Each route counts its launches under its own key (``knn_merge[_cand]_lanes``,
``knn_merge[_cand]_ring``; the warp route by mode, ``_hd`` or ``_ld``).  The
routes' distances, ids and flags agree bit for bit.

Both run under ``fallback.guarded`` of the family "knn_merge", as their
JAX counterparts do: a pass-through unless a caller opts in."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.knn_merge.ref import (knn_merge_cand_ref,
                                               knn_merge_ref)

# the kernel's bounds (csrc/knn_merge.cu kMaxK, kMaxC); FUnc-SNE's
# validate_inputs states them for a config before any launch
MAX_K, MAX_C, _MAX_TABLES = 1024, 128, 2
# the lane route's bounds (csrc/row_sqdist.cuh kLaneM; one lane per element)
LANE_M, LANE_SLOTS = 8, 32
# the ring route's widths (csrc/row_sqdist.cuh kRingMinM: a float4 of each
# row for every lane; kRingMaxM: the query row's float4s a lane holds in
# registers); B1's routes share them
RING_MIN_M, RING_MAX_M = 128, 1024
_KINDS = {"uniform": 0, "one_hop": 1, "two_hop": 2, "extra": 3}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FAMILY = "knn_merge"


class _MergeArgs(ctypes.Structure):
    """Field for field the ``MergeArgs`` struct of csrc/knn_merge.cu."""
    _fields_ = [
        ("x", _P), ("n", _I64), ("m", _I64), ("qid", _P), ("b", _I64),
        ("cur_idx", _P), ("cur_d", _P), ("cur_valid", _P), ("k", _I),
        ("c", _I), ("salt", _P), ("active", _P),
        ("first", _P * 2), ("second", _P * 2), ("extra", _P),
        ("cand", _P), ("cand_valid", _P),
        ("second_n", _I64 * 2), ("first_w", _I * 2), ("second_w", _I * 2),
        ("extra_w", _I),
        ("kind", _I * MAX_C), ("tab", _I * MAX_C), ("sec", _I * MAX_C),
        ("col", _I * MAX_C),
        ("new_idx", _P), ("new_d", _P), ("improved", _P),
    ]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _merge_args(x, qid, cur_idx, cur_d, cur_valid, c):
    """Check the inputs both kernels share and fill the common fields of
    the argument block (the outputs' are filled by :func:`_alloc_outs`)."""
    req = _build.require
    n, m = x.shape
    b, k = cur_idx.shape
    req(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous(),
        "x must be a contiguous (N, M) float32 tensor")
    req(qid.dtype == torch.int32 and qid.shape == (b,) and qid.is_contiguous(),
        "qid must be a contiguous (B,) int32 tensor")
    req(cur_idx.dtype == torch.int32 and cur_idx.is_contiguous()
        and 1 <= k <= MAX_K, f"cur_idx must be contiguous int32 (B, K<={MAX_K})")
    req(1 <= c <= MAX_C, f"need 1..{MAX_C} candidate slots, got {c}")
    if cur_d is not None:
        req(cur_d.dtype == torch.float32 and cur_d.shape == (b, k)
            and cur_d.is_contiguous(), "cur_d must be contiguous (B, K) float32")
    else:
        req(cur_valid.dtype == torch.bool and cur_valid.shape == (b, k)
            and cur_valid.is_contiguous(), "cur_valid must be (B, K) bool")
    return _MergeArgs(x=x.data_ptr(), n=n, m=m, qid=qid.data_ptr(), b=b,
                      cur_idx=cur_idx.data_ptr(), cur_d=_ptr(cur_d),
                      cur_valid=_ptr(cur_valid), k=k, c=c)


def _alloc_outs(a, x):
    """Allocate the outputs (new_idx, new_d, improved) of the argument
    block ``a`` on ``x``'s device and point ``a`` at them."""
    outs = (torch.empty((a.b, a.k), dtype=torch.int32, device=x.device),
            torch.empty((a.b, a.k), dtype=torch.float32, device=x.device),
            torch.empty((a.b,), dtype=torch.bool, device=x.device))
    a.new_idx, a.new_d, a.improved = (t.data_ptr() for t in outs)
    return outs


def merge_route(m, k, c, aligned=True):
    """The route of a merge over rows of ``m`` floats, K = ``k``, C = ``c``
    (``aligned``: x starts on 16 bytes): "lanes" when m <= LANE_M and
    k + c <= LANE_SLOTS; "ring" when ``aligned``, m % 4 == 0 and
    RING_MIN_M <= m <= RING_MAX_M; else "warp"."""
    if m <= LANE_M and k + c <= LANE_SLOTS:
        return "lanes"
    if aligned and m % 4 == 0 and RING_MIN_M <= m <= RING_MAX_M:
        return "ring"
    return "warp"


def _launch(op, a, x, mode):
    """Launch ``op`` ("knn_merge" or "knn_merge_cand") on the route its
    shape takes and count the launch under that route's key (the warp
    route's by mode)."""
    route = merge_route(a.m, a.k, a.c, x.data_ptr() % 16 == 0)
    _run(f"repro_{op}" + ("" if route == "warp" else f"_{route}"), a, x)
    LAUNCHES[f"{op}_{mode}" if route == "warp" else f"{op}_{route}"] += 1


def _run(entry, a, x):
    with torch.cuda.device(x.device):
        _build.call(entry, [ctypes.POINTER(_MergeArgs), _P], ctypes.byref(a),
                    _build.stream_of(x))


def knn_merge(x, qid, cur_idx, cur_d, cand, *, cand_active=None,
              cur_valid=None):
    """Score C precomputed candidates per row, dedup and top-K merge (B4).

    Args mirror ``repro.kernels.knn_merge.ops.knn_merge`` with a ``cand``:
      x: (N, M) f32 source matrix (X for HD refinement, Y for LD).
      qid: (B,) int32 query row ids.
      cur_idx: (B, K) int32 resident list; SENTINEL = invalid.
      cur_d: (B, K) f32 stored sorted distances, or None to re-score the
        current rows (LD mode), which requires ``cur_valid`` (B, K) bool.
      cand: (B, C) int32 candidates; SENTINEL and out-of-range ids are
        allowed (scored at the clipped id, deduped and merged raw).
      cand_active: optional (B, C) bool extra validity (active rows).
    Returns (new_idx (B, K) int32, new_d (B, K) f32, improved (B,) bool).
    """
    if (cur_d is None) == (cur_valid is None):
        raise ValueError("pass cur_d (HD mode) or cur_valid (rescore mode)")
    opt = [t for t in (cur_d, cur_valid, cand_active) if t is not None]
    ref = functools.partial(knn_merge_ref, x, qid, cur_idx, cur_d, cand,
                            cand_active=cand_active, cur_valid=cur_valid)
    if _build.kernel_device(x, qid, cur_idx, cand, *opt) == "cpu":
        return _build.guarded(_FAMILY, None, ref)
    b, c = cand.shape
    req = _build.require
    req(cand.dtype == torch.int32 and cand.ndim == 2 and b == qid.shape[0]
        and cand.is_contiguous(), "cand must be a contiguous (B, C) int32 tensor")
    if cand_active is not None:
        req(cand_active.dtype == torch.bool and cand_active.shape == (b, c)
            and cand_active.is_contiguous(),
            "cand_active must be a contiguous (B, C) bool tensor")
    a = _merge_args(x, qid, cur_idx, cur_d, cur_valid, c)
    a.cand, a.cand_valid = cand.data_ptr(), _ptr(cand_active)

    def launch():
        outs = _alloc_outs(a, x)
        _launch("knn_merge", a, x, "ld" if cur_d is None else "hd")
        return outs
    return _build.guarded(_FAMILY, launch)


def _slot_plan(sources):
    """Per-slot (kind, first table, second table, extra column)."""
    plan, e = [], 0
    for src in sources:
        kind, c = src[0], src[-1]
        if kind not in _KINDS:
            raise ValueError(f"unknown candidate source {kind!r}")
        for _ in range(c):
            f = src[1] if kind in ("one_hop", "two_hop") else 0
            s = src[2] if kind == "two_hop" else 0
            plan.append((_KINDS[kind], f, s, e if kind == "extra" else 0))
            e += kind == "extra"
    return plan


def knn_merge_cand(x, qid, cur_idx, cur_d, *, salt, sources,
                   first_tables=(), second_tables=(), extra=None,
                   active=None, cur_valid=None):
    """Generate C candidates per row, score, dedup and top-K merge (B2).

    Args mirror ``repro.kernels.knn_merge.ops.knn_merge`` in its
    candidate-fused mode:
      x: (N, M) f32 source matrix (X for HD refinement, Y for LD).
      qid: (B,) int32 query row ids.
      cur_idx: (B, K) int32 resident list; SENTINEL = invalid.
      cur_d: (B, K) f32 stored sorted distances, or None to re-score the
        current rows (LD mode), which requires ``cur_valid`` (B, K) bool.
      salt: int32 counter-RNG salt (a 0-dim tensor on x's device).
      sources: static candidate layout (``core.knn.counter_candidates``).
      first_tables: (B, Kf) int32 tables; second_tables: (N2, K2) int32.
      extra: (B, E) int32 slots of the ("extra", E) source.
      active: (N,) bool row membership, or None (all active).
    Returns (new_idx (B, K) int32, new_d (B, K) f32, improved (B,) bool).
    """
    if (cur_d is None) == (cur_valid is None):
        raise ValueError("pass cur_d (HD mode) or cur_valid (rescore mode)")
    sources = tuple(s for s in sources if s[-1] > 0)
    opt = [t for t in (cur_d, cur_valid, extra, active) if t is not None]
    ref = functools.partial(
        knn_merge_cand_ref, x, qid, cur_idx, cur_d, salt=salt,
        sources=sources, first_tables=first_tables,
        second_tables=second_tables, extra=extra, active=active,
        cur_valid=cur_valid)
    if _build.kernel_device(x, qid, cur_idx, salt, *first_tables,
                            *second_tables, *opt) == "cpu":
        return _build.guarded(_FAMILY, None, ref)
    req = _build.require
    plan = _slot_plan(sources)
    n = x.shape[0]
    b = cur_idx.shape[0]
    req(salt.dtype == torch.int32 and salt.numel() == 1, "salt must be int32")
    req(len(first_tables) <= _MAX_TABLES and len(second_tables) <= _MAX_TABLES,
        f"at most {_MAX_TABLES} first and second tables")
    for f in first_tables:
        req(f.dtype == torch.int32 and f.ndim == 2 and f.shape[0] == b
            and f.is_contiguous(), "first tables must be contiguous (B, Kf) int32")
    for s in second_tables:
        req(s.dtype == torch.int32 and s.ndim == 2 and s.is_contiguous(),
            "second tables must be contiguous (N2, K2) int32")
    for kind, f, s, _ in plan:
        req(kind not in (1, 2) or f < len(first_tables), "missing first table")
        req(kind != 2 or s < len(second_tables), "missing second table")
    n_extra = sum(kind == 3 for kind, *_ in plan)
    if n_extra:
        req(extra is not None and extra.dtype == torch.int32
            and extra.shape == (b, n_extra) and extra.is_contiguous(),
            f"extra must be a contiguous (B, {n_extra}) int32 tensor")
    if active is not None:
        req(active.dtype == torch.bool and active.shape == (n,)
            and active.is_contiguous(), "active must be a (N,) bool tensor")

    a = _merge_args(x, qid, cur_idx, cur_d, cur_valid, len(plan))
    a.salt, a.active = salt.data_ptr(), _ptr(active)
    a.extra, a.extra_w = _ptr(extra), n_extra
    for i, f in enumerate(first_tables):
        a.first[i], a.first_w[i] = f.data_ptr(), f.shape[1]
    for i, s in enumerate(second_tables):
        a.second[i], a.second_n[i], a.second_w[i] = (s.data_ptr(),
                                                     s.shape[0], s.shape[1])
    for g, (kind, f, s, e) in enumerate(plan):
        a.kind[g], a.tab[g], a.sec[g], a.col[g] = kind, f, s, e

    def launch():
        outs = _alloc_outs(a, x)
        _launch("knn_merge_cand", a, x, "ld" if cur_d is None else "hd")
        return outs
    return _build.guarded(_FAMILY, launch)
