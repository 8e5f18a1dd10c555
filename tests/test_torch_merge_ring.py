"""The ring route of B2/B4 (neighbour refinement on wide rows) on the
card's side, with the C call stubbed on meta tensors.

``merge_route`` sends rows of ``RING_MIN_M`` to ``RING_MAX_M`` floats with
M % 4 == 0 on a 16-byte-aligned x to the ring route (HD refinement and NND
at MNIST's 784).  The kernel's launcher sizes the block itself: 4 warps,
each with a ring of 2 whole rows (3 past 12 candidates), the lists and a
schedule; a static_assert in ``csrc/knn_merge.cu`` holds that this fits a
block's shared memory at K = 1024, C = 128 and M = 1,024, and a test here
works the same size out by hand.  Below ``RING_MIN_M``, at other widths and
on a misaligned x the warp route stays (the routes by shape and the
launches each counts: ``tests/test_torch_small_width.py``).  The kernel
itself is held to its plain version, and to the warp route bit for bit, on
the card by ``chip_smoke.py`` and ``scripts/merge_wide_ab.py``.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.knn_merge import ops as merge_ops
from repro_torch.kernels.knn_merge.ops import knn_merge

def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def launched(monkeypatch):
    """Stub B2/B4's C call on meta tensors: record each launch's entry and
    argument block, with the device check answering 'cuda'."""
    calls = []

    def record(entry, a, x):
        calls.append((entry, {f: getattr(a, f) for f, _ in a._fields_}))
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    # the wrapper builds the kernels before its guarded launch
    monkeypatch.setattr(_build, "library", lambda: None)
    monkeypatch.setattr(merge_ops, "_run", record)
    kernels.reset_launches()
    return calls


# a block's dynamic shared memory on the H100 (csrc/knn_merge.cu kMaxSmem)
MAX_SMEM = 232_448


def ring_block_bytes(m, k, c):
    """The ring route's block as csrc/knn_merge.cu lays it out, worked out
    by hand: 4 warps, each with 2 stages (3 past 12 candidates) of a row of
    m floats and an 8-byte mbarrier, the lists cur, cur_d, cand, gat,
    cand_d, ok (2K + 4C ints) and the schedule (K + C ints), 16-aligned."""
    stages = 3 if c > 12 else 2
    per_warp = stages * (4 * m + 8) + 4 * (2 * k + 4 * c) + 4 * (k + c)
    return 4 * (per_warp + (-per_warp) % 16)


@pytest.mark.parametrize("m,k,c", [
    (1024, 1024, 128), (784, 1024, 128), (128, 1024, 128), (784, 32, 10),
    (784, 32, 14), (784, 32, 16), (784, 128, 64)])
def test_ring_block_fits_and_launches(launched, m, k, c):
    """At the kernels' bounds (K = 1024, C = 128, M up to 1,024) and at the
    main path's shapes the ring's block fits a block's 227 KB (106 KB at
    the bounds), so the route is chosen by width and alignment alone and B4
    launches the ring's entry, counted under its key."""
    assert ring_block_bytes(m, k, c) <= MAX_SMEM
    n, b = 300, 16
    knn_merge(meta((n, m)), meta((b,), torch.int32),
              meta((b, k), torch.int32), meta((b, k)),
              meta((b, c), torch.int32))
    (entry, a), = launched
    assert entry == "repro_knn_merge_ring"
    assert (a["m"], a["k"], a["c"], a["b"]) == (m, k, c, b)
    assert kernels.LAUNCHES["knn_merge_ring"] == 1
    assert kernels.LAUNCHES["knn_merge_hd"] == 0


def test_misaligned_x_takes_the_warp_route(launched):
    """A view of x that starts 4 bytes into its storage has no 16-byte
    rows: the warp route, by its address, not a failed launch."""
    n, b, m = 300, 16, 784
    assert merge_ops.merge_route(m, 32, 16, aligned=False) == "warp"
    assert merge_ops.merge_route(8, 16, 8, aligned=False) == "lanes"
    x = meta((n * m + 1,))[1:].view(n, m)
    assert x.data_ptr() % 16 == 4
    knn_merge(x, meta((b,), torch.int32), meta((b, 32), torch.int32),
              meta((b, 32)), meta((b, 16), torch.int32))
    (entry, _), = launched
    assert entry == "repro_knn_merge"
    assert kernels.LAUNCHES["knn_merge_hd"] == 1
    assert kernels.LAUNCHES["knn_merge_ring"] == 0


@pytest.mark.parametrize("bad", ["cur_int64", "c_past_max", "k_past_max",
                                 "no_mode", "cand_shape", "x_float64",
                                 "qid_int64", "cand_active_shape"])
def test_ring_inputs_checked_before_launch(launched, bad):
    """What the kernels do not take raises ValueError before any launch at
    a ring width; nothing falls back."""
    n, b, m, k, c = 500, 8, 784, 32, 16
    x, qid = meta((n, m)), meta((b,), torch.int32)
    cur, cur_d = meta((b, k), torch.int32), meta((b, k))
    cand, kw = meta((b, c), torch.int32), {}
    if bad == "cur_int64":
        cur = meta((b, k), torch.int64)
    if bad == "c_past_max":
        cand = meta((b, merge_ops.MAX_C + 1), torch.int32)
    if bad == "k_past_max":
        cur = meta((b, merge_ops.MAX_K + 1), torch.int32)
        cur_d = meta((b, merge_ops.MAX_K + 1))
    if bad == "no_mode":
        cur_d = None
    if bad == "cand_shape":
        cand = meta((b + 1, c), torch.int32)
    if bad == "x_float64":
        x = meta((n, m), torch.float64)
    if bad == "qid_int64":
        qid = meta((b,), torch.int64)
    if bad == "cand_active_shape":
        kw["cand_active"] = meta((b, c + 1), torch.bool)
    with pytest.raises(ValueError):
        knn_merge(x, qid, cur, cur_d, cand, **kw)
    assert launched == [] and set(kernels.LAUNCHES.values()) == {0}
