"""Deterministic segment sum (the unfused paths' symmetrisation): the plain
version on the CPU, the CUDA kernel of ``csrc/segment_sum.cu`` on the card."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


class _SegmentArgs(ctypes.Structure):
    """Field for field the ``SegmentArgs`` struct of csrc/segment_sum.cu."""
    _fields_ = [("val", _P), ("perm", _P), ("offs", _P), ("out", _P),
                ("n", _I64), ("d", _I)]


def segment_runs(idx, n: int):
    """The stable order of ``idx`` and each row's run in it: ((E,) int64
    perm, (n + 1,) int64 run starts).  The keys are sorted as int32, half
    the radix passes of int64 keys."""
    srt, perm = torch.sort(idx.to(torch.int32), stable=True)
    offs = torch.searchsorted(
        srt, torch.arange(n + 1, dtype=torch.int32, device=idx.device))
    return perm, offs


def segment_sum(idx, val, n: int):
    """(E,) int ids in [0, n), (E, d) f32 rows -> (n, d) f32 sums, each row
    added in increasing e (a sequential ``index_add_`` into zeros), so two
    calls on the same inputs agree bit for bit."""
    if _build.kernel_device(idx, val) == "cpu":
        return segment_sum_ref(idx, val, n)
    req = _build.require
    req(idx.ndim == 1 and not idx.is_floating_point(), "idx must be (E,) int")
    req(val.dtype == torch.float32 and val.ndim == 2
        and val.shape[0] == idx.shape[0] and val.is_contiguous(),
        "val must be a contiguous (E, d) float32 tensor")
    req(0 <= n < 2 ** 31 - 1, "n must fit int32 keys")
    dev = val.device
    perm, offs = segment_runs(idx, n)
    out = torch.empty((n, val.shape[1]), dtype=torch.float32, device=dev)
    a = _SegmentArgs(val=val.data_ptr(), perm=perm.data_ptr(),
                     offs=offs.data_ptr(), out=out.data_ptr(), n=n,
                     d=val.shape[1])
    with torch.cuda.device(dev):
        _build.call("repro_segment_sum", [ctypes.POINTER(_SegmentArgs), _P],
                    ctypes.byref(a), _build.stream_of(val))
    LAUNCHES["segment_sum"] += 1
    return out
