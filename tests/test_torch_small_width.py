"""The wrappers of B2/B4 (neighbour refinement) and B3 (scatter-fused
forces) on the card's side, with the C call stubbed on meta tensors.

B2 and B4 run one of three routes, chosen by shape (``merge_route``): the
lane route for rows of at most ``LANE_M`` floats with K + C <= 32
(FUnc-SNE's LD refinement), the ring route for rows of 128 to 1,024 floats
with M % 4 == 0 (HD refinement and NND at MNIST's 784;
``tests/test_torch_merge_ring.py`` holds its block's size), the warp route
otherwise; each counts its launches under its own key.  B3's wrapper
passes its argument block (the segments, two allocations laid out as the
kernel reads them) and raises on what the kernel does not take, before any
launch.  The kernels themselves are held to their plain versions on the
card by ``chip_smoke.py``; the plain versions to the JAX package by
``tests/test_torch_kernels.py``.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.knn_merge import ops as merge_ops
from repro_torch.kernels.knn_merge.ops import knn_merge, knn_merge_cand
from repro_torch.kernels.ne_forces import ops as force_ops
from repro_torch.kernels.ne_forces.ops import ne_forces_scatter

MERGE_KEYS = ("knn_merge_cand_hd", "knn_merge_cand_ld", "knn_merge_hd",
              "knn_merge_ld", "knn_merge_cand_lanes", "knn_merge_lanes",
              "knn_merge_cand_ring", "knn_merge_ring")


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def launched(monkeypatch):
    """Stub the C calls of B2/B4 and B3 on meta tensors: record each
    launch's entry and argument block (and B3's width d), with the device
    check answering 'cuda'."""
    calls = []

    def record(entry, a, *rest):
        calls.append((entry, {f: getattr(a, f) for f, _ in a._fields_},
                      rest[0] if len(rest) == 2 else None))
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    # the wrapper builds the kernels before its guarded launch
    monkeypatch.setattr(_build, "library", lambda: None)
    monkeypatch.setattr(merge_ops, "_run", record)
    monkeypatch.setattr(force_ops, "_run", record)
    kernels.reset_launches()
    return calls


@pytest.mark.parametrize("m,k,c,route", [
    (2, 16, 8, "lanes"), (5, 16, 8, "lanes"), (8, 16, 8, "lanes"),
    (2, 16, 16, "lanes"), (2, 31, 1, "lanes"), (784, 32, 10, "ring"),
    (2, 128, 64, "warp"), (9, 16, 8, "warp"), (32, 16, 8, "warp"),
    (2, 16, 17, "warp"), (16, 32, 10, "warp"),
    # the ring: HD (C 10, 14 with reverse edges) and NND at 784, K 128 C 64,
    # the bounds, the widths' edges
    (784, 32, 14, "ring"), (784, 32, 16, "ring"), (784, 128, 64, "ring"),
    (784, 1024, 128, "ring"), (128, 32, 10, "ring"), (1024, 32, 10, "ring"),
    # the warp route: M % 4 != 0, below or past the ring's widths
    (783, 32, 10, "warp"), (30, 16, 8, "warp"), (124, 32, 10, "warp"),
    (1028, 32, 10, "warp"), (2048, 32, 10, "warp")])
def test_merge_route_by_shape(m, k, c, route):
    assert merge_ops.merge_route(m, k, c) == route


@pytest.mark.parametrize("m,k,c,mode,route", [
    (2, 16, 8, "ld", "lanes"), (784, 32, 10, "hd", "ring"),
    (2, 128, 64, "ld", "warp"), (2, 128, 64, "hd", "warp"),
    (8, 16, 8, "hd", "lanes"), (32, 16, 8, "ld", "warp"),
    (784, 128, 64, "hd", "ring"), (784, 32, 10, "ld", "ring"),
    (783, 32, 10, "hd", "warp"), (1024, 1024, 128, "hd", "ring")])
def test_knn_merge_cand_launches_its_route(launched, m, k, c, mode, route):
    """B2 on the card: the entry of the route its shape takes, the launch
    counted under that route's key (the warp route's by mode), nothing
    else; outputs of (B, K), (B, K), (B,)."""
    n, b = 500, 64
    x, qid = meta((n, m)), meta((b,), torch.int32)
    cur = meta((b, k), torch.int32)
    cur_d, cur_valid = ((None, meta((b, k), torch.bool)) if mode == "ld"
                        else (meta((b, k)), None))
    sources = (("two_hop", 0, 0, c - 4), ("one_hop", 0, 2), ("uniform", 2))
    out = knn_merge_cand(x, qid, cur, cur_d, salt=meta((), torch.int32),
                         sources=sources, first_tables=(cur,),
                         second_tables=(meta((n, k), torch.int32),),
                         active=meta((n,), torch.bool), cur_valid=cur_valid)
    assert [t.shape for t in out] == [(b, k), (b, k), (b,)]
    (entry, a, _), = launched
    warp = route == "warp"
    assert entry == "repro_knn_merge_cand" + ("" if warp else f"_{route}")
    assert (a["m"], a["k"], a["c"], a["b"], a["n"]) == (m, k, c, b, n)
    assert list(a["kind"][:c]) == [2] * (c - 4) + [1] * 2 + [0] * 2
    key = f"knn_merge_cand_{mode if warp else route}"
    assert {kk: kernels.LAUNCHES[kk] for kk in MERGE_KEYS} == {
        kk: int(kk == key) for kk in MERGE_KEYS}


@pytest.mark.parametrize("m,k,c,mode,route", [
    (2, 16, 8, "ld", "lanes"), (784, 32, 16, "hd", "ring"),
    (784, 32, 10, "hd", "ring"), (2, 128, 64, "hd", "warp"),
    (5, 16, 8, "ld", "lanes"), (784, 32, 14, "hd", "ring"),
    (784, 128, 64, "hd", "ring"), (30, 32, 16, "hd", "warp"),
    (784, 32, 14, "ld", "ring"), (128, 32, 16, "hd", "ring")])
def test_knn_merge_launches_its_route(launched, m, k, c, mode, route):
    """B4 on the card: as B2, with the candidates and their validity from
    the (B, C) blocks."""
    n, b = 500, 48
    x, qid = meta((n, m)), meta((b,), torch.int32)
    cur, cand = meta((b, k), torch.int32), meta((b, c), torch.int32)
    cur_d, cur_valid = ((None, meta((b, k), torch.bool)) if mode == "ld"
                        else (meta((b, k)), None))
    out = knn_merge(x, qid, cur, cur_d, cand,
                    cand_active=meta((b, c), torch.bool), cur_valid=cur_valid)
    assert [t.shape for t in out] == [(b, k), (b, k), (b,)]
    (entry, a, _), = launched
    warp = route == "warp"
    assert entry == "repro_knn_merge" + ("" if warp else f"_{route}")
    assert (a["m"], a["k"], a["c"]) == (m, k, c)
    key = f"knn_merge_{mode if warp else route}"
    assert {kk: kernels.LAUNCHES[kk] for kk in MERGE_KEYS} == {
        kk: int(kk == key) for kk in MERGE_KEYS}


def test_merge_input_checks_raise_before_launch(launched):
    """What neither route takes raises before any launch, on either."""
    n, b = 500, 8
    for m in (2, 784):
        x, qid = meta((n, m)), meta((b,), torch.int32)
        with pytest.raises(ValueError):        # int64 ids
            knn_merge(x, qid, meta((b, 16), torch.int64), None,
                      meta((b, 8), torch.int32),
                      cur_valid=meta((b, 16), torch.bool))
        with pytest.raises(ValueError):        # C past MAX_C
            knn_merge(x, qid, meta((b, 16), torch.int32), meta((b, 16)),
                      meta((b, merge_ops.MAX_C + 1), torch.int32))
        with pytest.raises(ValueError):        # neither cur_d nor cur_valid
            knn_merge(x, qid, meta((b, 16), torch.int32), None,
                      meta((b, 8), torch.int32))
    assert launched == [] and set(kernels.LAUNCHES.values()) == {0}


MAIN = ((("attraction", 32), ("repulsion", 16), ("repulsion", 16)),
        (True, True, False))


@pytest.mark.parametrize("n,b,d,segments,back", [
    (700, 700, 2) + MAIN, (700, 300, 8) + MAIN, (500, 500, 5) + MAIN,
    (400, 900, 32, (("attraction", 128), ("repulsion", 16)), (True, True)),
    (300, 300, 3, (("repulsion", 7),), (False,))])
def test_ne_forces_scatter_arguments(launched, n, b, d, segments, back):
    """B3 on the card: one launch of ``repro_ne_forces_scatter`` at width
    d with the segments as given, and two allocations laid out as the
    kernel reads them: floats (S fields of (N, d), the S wsums, then each
    row's aggregates as scratch) and int64 (S fixed-point fields, then
    S + 2 flag words); the fields and wsums returned are views of the
    first."""
    k = sum(size for _, size in segments)
    s = len(segments)
    scats, wsums = ne_forces_scatter(
        meta((n, d)), meta((b,), torch.int32), meta((b, k), torch.int32),
        meta((b, k)), meta(()), segments=segments, scatter_back=back)
    assert [t.shape for t in scats] == [(n, d)] * s
    assert [t.shape for t in wsums] == [(b,)] * s
    (entry, a, width), = launched
    assert entry == "repro_ne_forces_scatter" and width == d
    assert (a["n"], a["b"], a["k"], a["n_seg"]) == (n, b, k, s)
    starts = [sum(size for _, size in segments[:i]) for i in range(s)]
    assert list(a["seg_start"][:s]) == starts
    assert list(a["seg_size"][:s]) == [size for _, size in segments]
    assert list(a["seg_mode"][:s]) == [int(mode == "repulsion")
                                       for mode, _ in segments]
    assert list(a["seg_back"][:s]) == [int(v) for v in back]
    # a meta tensor's data_ptr is its byte offset into its allocation (a
    # c_void_p of 0 reads None)
    ptr = {f: a[f] or 0 for f in ("out", "wsum", "agg", "acc", "max_bits")}
    assert ptr["out"] == ptr["acc"] == 0
    assert ptr["wsum"] == 4 * s * n * d
    assert ptr["agg"] == 4 * s * (n * d + b)
    assert ptr["max_bits"] == 8 * s * n * d
    assert [t.data_ptr() for t in scats] == [4 * i * n * d for i in range(s)]
    assert [t.data_ptr() for t in wsums] == [4 * (s * n * d + i * b)
                                             for i in range(s)]
    assert kernels.LAUNCHES["ne_forces_scatter"] == 1


@pytest.mark.parametrize("bad", [
    "x_dtype", "x_strided", "qid_int64", "qid_short", "nbr_int64",
    "nbr_strided", "coef_shape", "coef_dtype", "alpha_dtype", "alpha_size",
    "sizes_sum", "too_many_segments", "mode", "back_length", "d_zero"])
def test_ne_forces_scatter_input_checks(launched, bad):
    """What B3's kernel does not take raises ValueError before any launch,
    on the card; nothing falls back."""
    n, b, d = 300, 200, 2
    segments, back = MAIN
    k = 64
    x, qid = meta((n, d)), meta((b,), torch.int32)
    nbr, coef, alpha = meta((b, k), torch.int32), meta((b, k)), meta(())
    if bad == "x_dtype":
        x = meta((n, d), torch.float64)
    if bad == "x_strided":
        x = meta((n, 2 * d))[:, :d]
    if bad == "qid_int64":
        qid = meta((b,), torch.int64)
    if bad == "qid_short":
        qid = meta((b - 1,), torch.int32)
    if bad == "nbr_int64":
        nbr = meta((b, k), torch.int64)
    if bad == "nbr_strided":
        nbr = meta((b, 2 * k), torch.int32)[:, :k]
    if bad == "coef_shape":
        coef = meta((b, k - 1))
    if bad == "coef_dtype":
        coef = meta((b, k), torch.float64)
    if bad == "alpha_dtype":
        alpha = meta((), torch.float64)
    if bad == "alpha_size":
        alpha = meta((2,))
    if bad == "sizes_sum":
        segments = (("attraction", 32), ("repulsion", 16), ("repulsion", 15))
    if bad == "too_many_segments":
        segments = (("attraction", 16),) * 2 + (("repulsion", 8),) * 4
        back = (True,) * 6
    if bad == "mode":
        segments = (("attraction", 32), ("repel", 16), ("repulsion", 16))
    if bad == "back_length":
        back = (True, True)
    if bad == "d_zero":
        x = meta((n, 0))
    with pytest.raises(ValueError):
        ne_forces_scatter(x, qid, nbr, coef, alpha, segments=segments,
                          scatter_back=back)
    assert launched == [] and kernels.LAUNCHES["ne_forces_scatter"] == 0


def test_cpu_runs_the_plain_versions():
    """CPU tensors take the plain versions and launch nothing."""
    gen = torch.Generator().manual_seed(0)
    n, b, k, c = 40, 40, 4, 3
    y = torch.randn((n, 2), generator=gen)
    qid = torch.arange(b, dtype=torch.int32)
    cur = torch.randint(0, n, (b, k), generator=gen, dtype=torch.int32)
    cand = torch.randint(0, n, (b, c), generator=gen, dtype=torch.int32)
    kernels.reset_launches()
    knn_merge(y, qid, cur, None, cand, cur_valid=torch.ones((b, k),
                                                            dtype=torch.bool))
    ne_forces_scatter(y, qid, cur, torch.rand((b, k), generator=gen),
                      torch.tensor(1.0), segments=(("attraction", k),))
    assert set(kernels.LAUNCHES.values()) == {0}
