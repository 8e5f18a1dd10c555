"""Deterministic segment sum (the unfused paths' symmetrisation): the plain
version on the CPU, the CUDA kernel of ``csrc/segment_sum.cu`` on the card.

The kernel orders each row's terms by a stable counting sort on the device
in two levels (groups of rows, each chunk of ``CHUNK_IDS`` ids ranked by
warps; then rows within a group) and adds each row's values in increasing
e; ``tests/test_torch_segment_csr.py`` holds that ordering, in plain
PyTorch, to the stable sort.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the constants of csrc/segment_sum.cu
GROUP = 128          # 1 << kMinGroupBits: rows of a group, at least
MAX_GROUPS = 2048    # kMaxGroups: more rows a group above 262,144 rows
MAX_GROUP_ROWS = 1024  # 1 << kMaxGroupBits
PLACE_WARPS = 16     # kPlaceWarps: warps of a block of the place pass
WARP_IDS = 288       # kWarpIds: consecutive ids a warp ranks in a chunk
CHUNK_IDS = PLACE_WARPS * WARP_IDS   # kChunkIds: ids of a block
MAX_N = MAX_GROUP_ROWS * MAX_GROUPS
MAX_D = 24576        # kStageFloats: the values of one id fill pass 3's stage
_INT_MAX = 2 ** 31 - 1


class _SegmentArgs(ctypes.Structure):
    """Field for field the ``SegmentArgs`` struct of csrc/segment_sum.cu."""
    _fields_ = [("val", _P), ("idx", _P), ("work", _P), ("out", _P),
                ("e", _I64), ("n", _I), ("d", _I)]


def group_rows(n: int) -> int:
    """Rows of a group for n rows: GROUP, doubled until at most MAX_GROUPS
    groups remain."""
    rows = GROUP
    while -(-n // rows) > MAX_GROUPS:
        rows *= 2
    return rows


def work_ints(n: int, e: int, d: int) -> int:
    """int32 words of the kernel's workspace: the groups' totals, starts
    and order, the chunk x group counts and their scan over chunks, the
    positions of the large groups' ranks (E), the values by group (E x d
    floats) and the rows within their groups (E uint16)."""
    ng = -(-n // group_rows(n))
    return 3 * ng + 1 + 2 * -(-e // CHUNK_IDS) * ng + e + e * d + -(-e // 2)


def _run(a: _SegmentArgs, dev, stream: int) -> None:
    with torch.cuda.device(dev):
        _build.call("repro_segment_sum", [ctypes.POINTER(_SegmentArgs), _P],
                    ctypes.byref(a), stream)


def launch(idx, val, n: int, out, work) -> None:
    """Run the kernel on the card into ``out`` ((n, d) float32), with
    ``work`` (``work_ints(n, E, d)`` int32) as its workspace."""
    req = _build.require
    req(idx.ndim == 1 and idx.dtype == torch.int32 and idx.is_contiguous(),
        "idx must be a contiguous (E,) int32 tensor")
    req(val.dtype == torch.float32 and val.ndim == 2
        and val.shape[0] == idx.shape[0] and val.is_contiguous(),
        "val must be a contiguous (E, d) float32 tensor")
    e_count, d = val.shape
    req(0 <= n <= MAX_N and e_count < _INT_MAX,
        f"n must be at most {MAX_N} rows and E below 2^31 - 1")
    req(1 <= d <= MAX_D, f"d must be in [1, {MAX_D}]")
    req(out.dtype == torch.float32 and tuple(out.shape) == (n, d)
        and out.is_contiguous(), f"out must be a contiguous ({n}, {d}) "
        "float32 tensor")
    req(work.dtype == torch.int32
        and work.numel() >= work_ints(n, e_count, d),
        f"work must hold {work_ints(n, e_count, d)} int32")
    if n == 0:
        return
    a = _SegmentArgs(val=val.data_ptr(), idx=idx.data_ptr(),
                     work=work.data_ptr(), out=out.data_ptr(), e=e_count,
                     n=n, d=d)
    _run(a, val.device, _build.stream_of(val))
    LAUNCHES["segment_sum"] += 1


def segment_sum(idx, val, n: int):
    """(E,) int ids in [0, n), (E, d) f32 rows -> (n, d) f32 sums, each row
    added in increasing e (a sequential ``index_add_`` into zeros), so two
    calls on the same inputs agree bit for bit.  On the card the ids must
    be int32."""
    if _build.kernel_device(idx, val) == "cpu":
        return segment_sum_ref(idx, val, n)
    dev = val.device
    out = torch.empty((n, val.shape[-1]), dtype=torch.float32, device=dev)
    work = torch.empty(work_ints(n, idx.shape[0], val.shape[-1]),
                       dtype=torch.int32, device=dev)
    launch(idx, val, n, out, work)
    return out
