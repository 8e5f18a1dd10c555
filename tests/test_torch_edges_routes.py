"""B5 and B7's three routes (edge-emitting forces) on the card's side, with
the C call stubbed on meta tensors, and their plain versions against the
JAX package at the widths of the warp and the staged routes.

``edges_route`` sends rows of at most ``ROUNDS_MAX_D`` floats to the rounds
route (a warp runs a row's rounds of B3's plan, or two rows of one segment
of at most 16 edges), rows of the ``STAGED_WIDTHS`` (8 and 32 floats, the
widths the flag paths run past the rounds route's) with the neighbour rows
on 16 bytes to the staged route (the same rounds, each chunk of 32
neighbour rows and edges through shared memory) and the rest to the warp
route (one warp per row).  Each route has its own C entry and launch
counter; the C entries build the round plan from the segment sizes.  The
kernels themselves are held to their plain versions, and to the warp route
bit for bit, on the card by ``chip_smoke.py`` and
``scripts/forces_merge_ab.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.knn import SENTINEL  # noqa: E402
from repro.kernels.ne_forces.ref import ne_forces_gather_ref as j_gather_ref  # noqa: E402
from repro.kernels.ne_forces.ref import ne_forces_ref as j_forces_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ne_forces import ops  # noqa: E402
from repro_torch.kernels.ne_forces.ops import (  # noqa: E402
    STAGED_WIDTHS, edges_route, ne_forces, ne_forces_gather)

KEYS = ("ne_forces", "ne_forces_rounds", "ne_forces_staged",
        "ne_forces_gather", "ne_forces_gather_rounds",
        "ne_forces_gather_staged")
MAIN = (("attraction", 32), ("repulsion", 16), ("repulsion", 16))


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def misaligned(*shape):
    """A contiguous meta tensor of ``shape`` whose data lie 4 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    t = meta((n + 1,))[1:].view(shape)
    assert t.data_ptr() % 16 == 4
    return t


@pytest.fixture
def launched(monkeypatch):
    """Stub the C calls of B5 and B7 on meta tensors: record each
    launch's entry, argument block and width, with the device check
    answering 'cuda'."""
    calls = []

    def record(entry, a, d, like):
        calls.append((entry, a, d))
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    # the wrapper builds the kernels before its guarded launch
    monkeypatch.setattr(_build, "library", lambda: None)
    monkeypatch.setattr(ops, "_run", record)
    kernels.reset_launches()
    return calls


@pytest.mark.parametrize("d,route", [
    (1, "rounds"), (2, "rounds"), (3, "rounds"), (4, "rounds"),
    (5, "warp"), (7, "warp"), (8, "staged"), (9, "warp"), (12, "warp"),
    (16, "warp"), (32, "staged"), (33, "warp"), (784, "warp")])
def test_edges_route_by_width(d, route):
    """The rounds route up to 4 floats, the staged route at 8 and 32 (the
    flag paths' widths past 4), the warp route at every other width."""
    assert STAGED_WIDTHS == (8, 32)
    assert edges_route(d) == route


@pytest.mark.parametrize("d", STAGED_WIDTHS)
@pytest.mark.parametrize("op", ["ne_forces", "ne_forces_gather"])
def test_misaligned_rows_take_the_warp_route(launched, op, d):
    """Neighbour rows off a 16-byte boundary, which the staged route's
    float4 copies cannot take, go to the warp route, counted under its
    key; the rounds route is not concerned (its vector loads check the
    rows themselves)."""
    n, b, k = 300, 201, 16
    assert edges_route(d, aligned=False) == "warp"
    if op == "ne_forces":
        ne_forces(meta((b, d)), misaligned(b, k, d), meta((b, k)), meta(()),
                  mode="repulsion")
    else:
        ne_forces_gather(misaligned(n, d), meta((b,), torch.int32),
                         meta((b, k), torch.int32), meta((b, k)), meta(()),
                         segments=(("repulsion", k),), emit_edges=(True,))
    (entry, _, width), = launched
    assert entry == "repro_ne_forces_edges" and width == d
    assert {k_: kernels.LAUNCHES[k_] for k_ in KEYS} == \
        {k_: int(k_ == op) for k_ in KEYS}


@pytest.mark.parametrize("d", [2, 5, 8, 12, 32, 200])
def test_ne_forces_gather_launches_its_route(launched, d):
    """B5 at the scatter_fused=False path's segments: one launch of its
    route's C entry with the segments in its argument block, counted under
    its own key."""
    n, b = 500, 301
    route = edges_route(d)
    aggs, edges, wsums = ne_forces_gather(
        meta((n, d)), meta((b,), torch.int32), meta((b, 64), torch.int32),
        meta((b, 64)), meta(()), segments=MAIN,
        emit_edges=(True, True, False))
    assert [t.shape for t in aggs] == [(b, d)] * 3
    assert [None if e is None else e.shape for e in edges] == \
        [(b, 32, d), (b, 16, d), None]
    assert [t.shape for t in wsums] == [(b,)] * 3
    (entry, a, width), = launched
    suffix = "" if route == "warp" else f"_{route}"
    assert entry == "repro_ne_forces_edges" + suffix and width == d
    assert (a.n, a.b, a.k, a.n_seg) == (n, b, 64, 3)
    assert list(a.seg_size[:3]) == [32, 16, 16]
    assert list(a.seg_start[:3]) == [0, 32, 48]
    assert list(a.seg_mode[:3]) == [0, 1, 1]
    assert a.edge[2] is None
    key = "ne_forces_gather" + suffix
    assert {k: kernels.LAUNCHES[k] for k in KEYS} == \
        {k: int(k == key) for k in KEYS}


@pytest.mark.parametrize("d", [2, 5, 8, 32, 200])
@pytest.mark.parametrize("k", [16, 32])
def test_ne_forces_launches_its_route(launched, d, k):
    """B7, one segment a launch: its route's C entry, its own key (at K 16
    the rounds and staged routes put two rows on a warp, at K 32 one)."""
    b = 301
    agg, edge, wsum = ne_forces(meta((b, d)), meta((b, k, d)), meta((b, k)),
                                meta(()), mode="repulsion")
    assert (agg.shape, edge.shape, wsum.shape) == ((b, d), (b, k, d), (b,))
    route = edges_route(d)
    (entry, a, width), = launched
    suffix = "" if route == "warp" else f"_{route}"
    assert entry == "repro_ne_forces_edges" + suffix and width == d
    assert (a.b, a.k, a.n_seg, a.seg_size[0], a.seg_mode[0]) == (b, k, 1, k, 1)
    assert a.x is None and a.nbr_idx is None
    key = "ne_forces" + suffix
    assert {k_: kernels.LAUNCHES[k_] for k_ in KEYS} == \
        {k_: int(k_ == key) for k_ in KEYS}


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("bad", ["x_strided", "qid_int64", "nbr_int64",
                                 "emit_length"])
def test_ne_forces_gather_input_checks(launched, d, bad):
    """What B5's kernels do not take raises ValueError before any launch,
    on the rounds and the staged route; nothing falls back."""
    n, b, k = 300, 200, 64
    x, qid = meta((n, d)), meta((b,), torch.int32)
    nbr, coef = meta((b, k), torch.int32), meta((b, k))
    segments, emit = MAIN, (True, True, False)
    if bad == "x_strided":
        x = meta((n, 2 * d))[:, :d]
    if bad == "qid_int64":
        qid = meta((b,), torch.int64)
    if bad == "nbr_int64":
        nbr = meta((b, k), torch.int64)
    if bad == "emit_length":
        emit = (True, True)
    with pytest.raises(ValueError):
        ne_forces_gather(x, qid, nbr, coef, meta(()), segments=segments,
                         emit_edges=emit)
    assert launched == [] and set(kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("d", [2, 32])
@pytest.mark.parametrize("bad", ["y_strided", "nbr_shape", "mode"])
def test_ne_forces_input_checks(launched, d, bad):
    """What B7's kernels do not take raises ValueError before any launch."""
    b, k = 200, 16
    y, nbr, coef = meta((b, d)), meta((b, k, d)), meta((b, k))
    mode = "attraction"
    if bad == "y_strided":
        y = meta((b, 2 * d))[:, :d]
    if bad == "nbr_shape":
        nbr = meta((b, k, d + 1))
    if bad == "mode":
        mode = "sideways"
    with pytest.raises(ValueError):
        ne_forces(y, nbr, coef, meta(()), mode=mode)
    assert launched == [] and set(kernels.LAUNCHES.values()) == {0}


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("d", [5, 32])
def test_gather_plain_vs_jax_at_route_widths(d):
    """B5's plain version on the CPU (no launch counted) against the JAX
    reference at d = 5 (the warp route at a runtime width) and 32 (the
    staged route's widest): the flag path's segments, the negatives not
    emitted, ids past both ends and SENTINEL slots."""
    rng = np.random.default_rng(d)
    n, b = 60, 37
    x = rng.normal(0, 3, (n, d)).astype(np.float32)
    qid = rng.integers(-2, n + 2, b).astype(np.int32)
    segments = (("attraction", 9), ("repulsion", 5), ("repulsion", 4))
    emit = (True, True, False)
    nbr = rng.integers(-3, n + 3, (b, 18)).astype(np.int32)
    nbr[rng.random((b, 18)) < 0.05] = SENTINEL
    coef = rng.uniform(0, 1, (b, 18)).astype(np.float32)
    coef[rng.random((b, 18)) < 0.1] = 0.0
    alpha = np.float32(0.9)
    kernels.reset_launches()
    got = ne_forces_gather(torch.from_numpy(x), torch.from_numpy(qid),
                           torch.from_numpy(nbr), torch.from_numpy(coef),
                           torch.tensor(alpha), segments=segments,
                           emit_edges=emit)
    assert set(kernels.LAUNCHES.values()) == {0}
    want = j_gather_ref(jnp.asarray(x), jnp.asarray(qid), jnp.asarray(nbr),
                        jnp.asarray(coef), alpha, segments=segments,
                        emit_edges=emit)
    assert got[1][2] is None and want[1][2] is None
    for g_all, w_all in zip(got, want):
        for g, w in zip(g_all, w_all):
            if w is not None:
                _close(g.numpy(), w)


@pytest.mark.parametrize("d", [5, 32])
@pytest.mark.parametrize("mode", ["attraction", "repulsion"])
def test_forces_plain_vs_jax_at_route_widths(d, mode):
    """B7's plain version on the CPU against the JAX reference at d = 5 and
    32, at K 16 (two rows a warp on the card), with duplicate neighbours
    and zero coefficients."""
    rng = np.random.default_rng(10 * d + len(mode))
    b, k = 41, 16
    y = rng.normal(0, 3, (b, d)).astype(np.float32)
    nbr = rng.normal(0, 3, (b, k, d)).astype(np.float32)
    nbr[:, 1] = nbr[:, 0]
    coef = rng.uniform(0, 1, (b, k)).astype(np.float32)
    coef[rng.random((b, k)) < 0.1] = 0.0
    alpha = np.float32(1.4)
    kernels.reset_launches()
    got = ne_forces(torch.from_numpy(y), torch.from_numpy(nbr),
                    torch.from_numpy(coef), torch.tensor(alpha), mode=mode)
    assert set(kernels.LAUNCHES.values()) == {0}
    want = j_forces_ref(jnp.asarray(y), jnp.asarray(nbr), jnp.asarray(coef),
                        alpha, mode=mode)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
