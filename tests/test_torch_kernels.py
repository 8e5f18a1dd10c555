"""The plain versions of the port's kernels against the JAX package.

Each plain PyTorch version (what a kernel wrapper runs on a CPU tensor, and
what ``chip_smoke.py`` holds the CUDA kernel against on the card) is held
against the JAX reference and the JAX Pallas kernel in interpret mode, on
inputs made with numpy from a seed:

  * B1 ``pairwise_sqdist_gather``: exact on quantised rows, float32 rounding
    on real ones (the sum over M runs in another order);
  * B2 ``knn_merge_cand`` in HD and LD-rescore mode: ids, distances and
    flags exact on quantised rows, with SENTINEL slots, inactive rows,
    out-of-range extra ids and duplicate candidates;
  * B3 ``ne_forces_scatter``: float32 rounding, with duplicate targets.

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.knn import SENTINEL  # noqa: E402
from repro.kernels.knn_merge.kernel import knn_merge_cand_pallas  # noqa: E402
from repro.kernels.knn_merge.ref import knn_merge_cand_ref as j_merge_ref  # noqa: E402
from repro.kernels.ne_forces.kernel import ne_forces_scatter_pallas  # noqa: E402
from repro.kernels.ne_forces.ref import ne_forces_scatter_ref as j_forces_ref  # noqa: E402
from repro.kernels.pairwise_sqdist.kernel import pairwise_sqdist_gather_pallas  # noqa: E402
from repro.kernels.pairwise_sqdist.ref import pairwise_sqdist_gather_ref as j_sqdist_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.knn_merge.ops import knn_merge_cand  # noqa: E402
from repro_torch.kernels.ne_forces.ops import ne_forces_scatter  # noqa: E402
from repro_torch.kernels.pairwise_sqdist.ops import pairwise_sqdist_gather  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
J = jnp.asarray
# float32 tolerance of plain-vs-JAX comparisons on real-valued inputs:
# both sum in float32, in different orders
RTOL, ATOL = 2e-5, 1e-6


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("quantised", [True, False])
def test_sqdist_plain_vs_jax_ref_and_interpret(quantised):
    rng = np.random.default_rng(0)
    n, m, b, c = 70, 37, 45, 6
    x = rng.normal(size=(n, m))
    x = (np.round(x * 4) / 4 if quantised else x).astype(np.float32)
    qid = rng.integers(0, n, b).astype(np.int32)
    cand = rng.integers(-3, n + 3, (b, c)).astype(np.int32)
    cand[rng.random((b, c)) < 0.1] = SENTINEL
    got = pairwise_sqdist_gather(T(x), T(qid), T(cand)).numpy()
    for want in (j_sqdist_ref(J(x), J(qid), J(cand)),
                 pairwise_sqdist_gather_pallas(J(x), J(qid), J(cand),
                                               block_b=16, block_m=16,
                                               interpret=True)):
        if quantised:
            _eq(got, want, "sqdist")
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                       atol=ATOL)


def _merge_problem(n, m, b, k, seed):
    """Quantised rows; duplicate-free current lists sorted by their exact
    distance with SENTINEL tails; tables with SENTINEL entries; inactive
    rows; out-of-range extra ids."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (n, m)) / 4.0).astype(np.float32)
    qid = rng.permutation(n)[:b].astype(np.int32)
    cur = np.stack([rng.permutation(np.setdiff1d(np.arange(n), [q]))[:k]
                    for q in qid]).astype(np.int32)
    d0 = ((x[cur] - x[qid][:, None]) ** 2).sum(-1).astype(np.float32)
    sent = np.sort(rng.random((b, k)) < 0.2, axis=1)
    cur[sent], d0[sent] = SENTINEL, np.inf
    order = np.argsort(d0, axis=1, kind="stable")
    cur = np.take_along_axis(cur, order, 1)
    cur_d = np.take_along_axis(d0, order, 1)
    other = rng.integers(0, n, (b, 5)).astype(np.int32)
    other[rng.random((b, 5)) < 0.15] = SENTINEL
    sec_a = rng.integers(0, n, (n, k)).astype(np.int32)
    sec_a[rng.random((n, k)) < 0.1] = SENTINEL
    sec_b = rng.integers(0, n, (n, 5)).astype(np.int32)
    active = rng.random(n) >= 0.15
    extra = rng.integers(-2, n + 3, (b, 2)).astype(np.int32)
    cur_valid = (cur != SENTINEL) & (rng.random((b, k)) < 0.9)
    return dict(x=x, qid=qid, cur=cur, cur_d=cur_d, other=other,
                sec_a=sec_a, sec_b=sec_b, active=active, extra=extra,
                cur_valid=cur_valid)


@pytest.mark.parametrize("rescore", [False, True])
def test_merge_plain_vs_jax_ref_and_interpret(rescore):
    """HD mode (stored distances) and LD rescore mode, every source kind,
    exact on quantised rows."""
    p = _merge_problem(n=64, m=19 if not rescore else 2, b=40, k=8,
                       seed=7 + rescore)
    sources = (("two_hop", 0, 0, 3), ("one_hop", 1, 2), ("two_hop", 1, 1, 2),
               ("uniform", 2), ("extra", 2))
    salt = -123457 + 11 * rescore
    cd = None if rescore else p["cur_d"]
    cv = p["cur_valid"] if rescore else None
    got = knn_merge_cand(
        T(p["x"]), T(p["qid"]), T(p["cur"]), None if cd is None else T(cd),
        salt=torch.tensor(salt, dtype=torch.int32), sources=sources,
        first_tables=(T(p["cur"]), T(p["other"])),
        second_tables=(T(p["sec_a"]), T(p["sec_b"])), extra=T(p["extra"]),
        active=T(p["active"]), cur_valid=None if cv is None else T(cv))
    jkw = dict(salt=jnp.int32(salt), sources=sources,
               first_tables=(J(p["cur"]), J(p["other"])),
               second_tables=(J(p["sec_a"]), J(p["sec_b"])),
               extra=J(p["extra"]), active=J(p["active"]))
    want = j_merge_ref(J(p["x"]), J(p["qid"]), J(p["cur"]),
                       None if cd is None else J(cd),
                       cur_valid=None if cv is None else J(cv), **jkw)
    kern = knn_merge_cand_pallas(
        J(p["x"]), J(p["qid"]), J(p["cur"]), J(cv if rescore else cd),
        jkw["salt"], jkw["first_tables"], jkw["second_tables"], jkw["extra"],
        jkw["active"], sources=sources, rescore=rescore, block_b=16,
        block_m=8, interpret=True)
    for w_all, label in ((want, "ref"), (kern, "interpret")):
        for g, w, name in zip(got, w_all, ("idx", "d", "improved")):
            _eq(g.numpy(), w, f"{label}:{name}")
    d = got[1].numpy()
    assert (d[:, 1:] >= d[:, :-1]).all()       # NaN-safe sortedness
    assert (got[0].numpy() != p["cur"]).any()  # the merge admitted some


def test_forces_plain_vs_jax_ref_and_interpret():
    rng = np.random.default_rng(3)
    n, b, d = 80, 48, 2
    y = rng.normal(0, 3, (n, d)).astype(np.float32)
    qid = rng.permutation(n)[:b].astype(np.int32)
    segments = (("attraction", 6), ("repulsion", 4), ("repulsion", 3))
    back = (True, True, False)
    nbr = rng.integers(0, n, (b, 13)).astype(np.int32)
    nbr[:, 1] = nbr[:, 0]                    # duplicate targets in a row
    nbr[::3, 7] = nbr[1::3, 7][: len(nbr[::3])]
    nbr[rng.random((b, 13)) < 0.05] = SENTINEL
    coef = rng.uniform(0, 1, (b, 13)).astype(np.float32)
    coef[:, :6] /= 2.0 * n
    coef[rng.random((b, 13)) < 0.1] = 0.0
    alpha = np.float32(0.7)
    scats, wsums = ne_forces_scatter(T(y), T(qid), T(nbr), T(coef),
                                     torch.tensor(alpha), segments=segments,
                                     scatter_back=back)
    for want in (j_forces_ref(J(y), J(qid), J(nbr), J(coef), alpha,
                              segments=segments, scatter_back=back),
                 ne_forces_scatter_pallas(J(y), J(qid), J(nbr), J(coef),
                                          alpha, segments=segments,
                                          scatter_back=back, block_b=16,
                                          interpret=True)):
        for g, w in zip(scats + wsums, want[0] + want[1]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                       atol=ATOL * np.abs(w).max())


def test_wrappers_dispatch_on_device():
    """A CPU tensor runs the plain version and counts no launch; a tensor
    on another device raises instead of falling back."""
    before = dict(kernels.LAUNCHES)
    x = torch.zeros((4, 3))
    ids = torch.arange(4, dtype=torch.int32)
    pairwise_sqdist_gather(x, ids, ids[:, None])
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        pairwise_sqdist_gather(x.to("meta"), ids.to("meta"),
                               ids[:, None].to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        _build.kernel_device(x, ids.to("meta"))
    with pytest.raises(ValueError):
        knn_merge_cand(x, ids, ids[:, None], None, salt=torch.tensor(0),
                       sources=(("uniform", 1),))
    kernels.reset_launches()
    assert set(kernels.LAUNCHES.values()) == {0}
    assert len(_build.source_tag()) == 16
