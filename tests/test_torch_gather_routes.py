"""B1's three routes (gathered squared distances) on the card's side, with
the C call stubbed on meta tensors, and B1's plain version against the JAX
package at each route's widths.

``gather_route`` sends rows of at most ``LANE_M`` floats to the lane route
(one thread a (query, candidate) pair: the LD lists at d = 2, 5, 8), rows of
``RING_MIN_M`` to ``RING_MAX_M`` floats with M % 4 == 0 on a 16-byte-aligned
x to the ring route (one warp a query row, its candidate rows streamed
through a ring in shared memory: MNIST's 784), and every other width (16,
32, 783, a misaligned x) to the warp route.  Each route has its own C entry
and launch counter; the kernel's launcher sizes the ring itself, so the
route depends on the width and the alignment alone, whatever C is.  The
kernels themselves are held to the plain version, and to the parent's warp
kernel bit for bit, on the card by ``chip_smoke.py`` and
``scripts/gather_ab.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.knn import SENTINEL  # noqa: E402
from repro.kernels.pairwise_sqdist.kernel import pairwise_sqdist_gather_pallas  # noqa: E402
from repro.kernels.pairwise_sqdist.ref import pairwise_sqdist_gather_ref as j_sqdist_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pairwise_sqdist import ops  # noqa: E402
from repro_torch.kernels.pairwise_sqdist.ops import (  # noqa: E402
    gather_route, pairwise_sqdist_gather)

KEYS = ("pairwise_sqdist_gather", "pairwise_sqdist_gather_lanes",
        "pairwise_sqdist_gather_ring")


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def misaligned(n, m):
    """A contiguous (n, m) view of x that starts 4 bytes into its storage."""
    x = meta((n * m + 1,))[1:].view(n, m)
    assert x.data_ptr() % 16 == 4
    return x


@pytest.fixture
def launched(monkeypatch):
    """Stub B1's C call on meta tensors: record each launch's entry and
    shapes, with the device check answering 'cuda'."""
    calls = []

    def record(entry, x, qid, cand, out):
        calls.append((entry, tuple(x.shape), tuple(cand.shape),
                      tuple(out.shape)))
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    # the wrapper builds the kernels before its guarded launch
    monkeypatch.setattr(_build, "library", lambda: None)
    monkeypatch.setattr(ops, "_run", record)
    kernels.reset_launches()
    return calls


@pytest.mark.parametrize("m,aligned,route", [
    (2, True, "lanes"), (5, True, "lanes"), (8, False, "lanes"),
    (128, True, "ring"), (784, True, "ring"), (1024, True, "ring"),
    (784, False, "warp"), (783, True, "warp"), (16, True, "warp"),
    (32, True, "warp"), (1028, True, "warp")])
def test_gather_route_by_shape(m, aligned, route):
    """The lane route up to 8 floats (any alignment: it reads float4s only
    where x allows), the ring from 128 to 1,024 floats with M % 4 == 0 on
    an aligned x, the warp route elsewhere."""
    assert gather_route(m, aligned) == route


@pytest.mark.parametrize("m,c,aligned,key", [
    (2, 16, True, "pairwise_sqdist_gather_lanes"),
    (2, 24, True, "pairwise_sqdist_gather_lanes"),
    (8, 16, False, "pairwise_sqdist_gather_lanes"),
    (784, 32, True, "pairwise_sqdist_gather_ring"),
    (784, 10, True, "pairwise_sqdist_gather_ring"),
    (128, 200, True, "pairwise_sqdist_gather_ring"),
    (783, 32, True, "pairwise_sqdist_gather"),
    (16, 32, True, "pairwise_sqdist_gather"),
    (784, 10, False, "pairwise_sqdist_gather")])
def test_each_route_launches_its_entry(launched, m, c, aligned, key):
    """Each route calls its own C entry (``repro_<key>``) once, with the
    caller's shapes and a (B, C) output, and counts under its own key; no
    other counter moves."""
    n, b = 300, 17
    x = meta((n, m)) if aligned else misaligned(n, m)
    out = pairwise_sqdist_gather(x, meta((b,), torch.int32),
                                 meta((b, c), torch.int32))
    assert out.shape == (b, c) and out.dtype == torch.float32
    assert launched == [(f"repro_{key}", (n, m), (b, c), (b, c))]
    assert {k: kernels.LAUNCHES[k] for k in KEYS} == \
        {k: int(k == key) for k in KEYS}
    assert sum(kernels.LAUNCHES.values()) == 1


@pytest.mark.parametrize("m", [2, 784])
@pytest.mark.parametrize("bad", ["x_float64", "x_1d", "x_strided",
                                 "qid_int64", "cand_int64", "cand_rows",
                                 "cand_strided"])
def test_inputs_checked_before_launch(launched, m, bad):
    """What the kernels do not take raises ValueError before any launch, on
    every route; nothing falls back."""
    n, b, c = 300, 8, 10
    x, qid, cand = meta((n, m)), meta((b,), torch.int32), \
        meta((b, c), torch.int32)
    if bad == "x_float64":
        x = meta((n, m), torch.float64)
    if bad == "x_1d":
        x = meta((n * m,))
    if bad == "x_strided":
        x = meta((m, n)).t()
    if bad == "qid_int64":
        qid = meta((b,), torch.int64)
    if bad == "cand_int64":
        cand = meta((b, c), torch.int64)
    if bad == "cand_rows":
        cand = meta((b + 1, c), torch.int32)
    if bad == "cand_strided":
        cand = meta((c, b), torch.int32).t()
    with pytest.raises(ValueError):
        pairwise_sqdist_gather(x, qid, cand)
    assert launched == [] and set(kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("m", [2, 8, 16, 128])
@pytest.mark.parametrize("quantised", [True, False])
def test_plain_vs_jax_at_route_widths(m, quantised):
    """On the CPU the wrapper runs the plain version, counts no launch, and
    matches the JAX reference and the Pallas kernel in interpret mode at the
    lane (2, 8), warp (16) and ring (128) widths: exactly on quantised rows,
    within float32 rounding on real ones (the sum over M runs in another
    order); with ids past both ends and SENTINEL slots, which score at the
    clipped id."""
    rng = np.random.default_rng(m)
    n, b, c = 40, 19, 6
    x = rng.normal(size=(n, m))
    x = (np.round(x * 4) / 4 if quantised else x).astype(np.float32)
    qid = rng.integers(-2, n + 2, b).astype(np.int32)
    cand = rng.integers(-3, n + 3, (b, c)).astype(np.int32)
    cand[rng.random((b, c)) < 0.1] = SENTINEL
    kernels.reset_launches()
    got = pairwise_sqdist_gather(torch.from_numpy(x), torch.from_numpy(qid),
                                 torch.from_numpy(cand)).numpy()
    assert set(kernels.LAUNCHES.values()) == {0}
    for want in (j_sqdist_ref(jnp.asarray(x), jnp.asarray(qid),
                              jnp.asarray(cand)),
                 pairwise_sqdist_gather_pallas(
                     jnp.asarray(x), jnp.asarray(qid), jnp.asarray(cand),
                     block_b=16, block_m=16, interpret=True)):
        if quantised:
            np.testing.assert_array_equal(got, np.asarray(want))
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                       atol=1e-6)
