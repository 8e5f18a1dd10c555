"""The port's unfused flag paths and reverse-edge candidates against the JAX
package.

Every setting here draws from the counter RNG, so the port reproduces the
JAX package's draws bit for bit:

  * the plain versions of B6 ``pairwise_sqdist``, B7 ``ne_forces`` and B5
    ``ne_forces_gather`` against the JAX references and the Pallas kernels
    in interpret mode (B6 exact on quantised rows; forces within the float32
    tolerance of ``tests/test_torch_kernels.py``);
  * ``counter_fill`` and ``reverse_neighbors`` exact;
  * one step and one T=10 chunk from one bridged state for each flag
    setting, with the discrete fields (ids, flags, reverse cache) exact and
    the floats within the tolerances of ``tests/test_torch_step.py``;
  * momentum conservation of the ``index_add_`` symmetrisation.

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import funcsne as jf  # noqa: E402
from repro.core import knn as j_knn  # noqa: E402
from repro.kernels.ne_forces.kernel import (ne_forces_gather_pallas,  # noqa: E402
                                            ne_forces_pallas)
from repro.kernels.ne_forces.ref import ne_forces_gather_ref as j_gather_ref  # noqa: E402
from repro.kernels.ne_forces.ref import ne_forces_ref as j_forces_ref  # noqa: E402
from repro.kernels.pairwise_sqdist.kernel import pairwise_sqdist_pallas  # noqa: E402
from repro.kernels.pairwise_sqdist.ref import pairwise_sqdist_ref as j_sqdist_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core import knn as t_knn  # noqa: E402
from repro_torch.kernels.ne_forces.ops import ne_forces, ne_forces_gather  # noqa: E402
from repro_torch.kernels.pairwise_sqdist.ops import pairwise_sqdist  # noqa: E402
from test_torch_kernels import ATOL, RTOL  # noqa: E402
from test_torch_step import _assert_states_match, _fields, _problem  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
J = jnp.asarray
SENTINEL = int(j_knn.SENTINEL)

# the flag settings of this slice (cand_fused stays on in all of them)
CONFIGS = {
    "gather_off": dict(gather_fused=False),
    "scatter_off": dict(scatter_fused=False),
    "merge_off": dict(merge_fused=False),
    "rev_refresh1": dict(c_hd_rev=4, rev_refresh=1),
    "rev_refresh10": dict(c_hd_rev=4, rev_refresh=10),
    "rev_gather_off": dict(c_hd_rev=4, rev_refresh=3, gather_fused=False),
}


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1.0))


# --------------------------------------------------------------------------
# Plain versions of B6, B7 and B5


@pytest.mark.parametrize("quantised", [True, False])
def test_pairwise_sqdist_plain_vs_jax_ref_and_interpret(quantised):
    rng = np.random.default_rng(5)
    b, c, m = 45, 6, 37
    q, cand = rng.normal(size=(b, m)), rng.normal(size=(b, c, m))
    if quantised:
        q, cand = np.round(q * 4) / 4, np.round(cand * 4) / 4
    q, cand = q.astype(np.float32), cand.astype(np.float32)
    got = pairwise_sqdist(T(q), T(cand)).numpy()
    for want in (j_sqdist_ref(J(q), J(cand)),
                 pairwise_sqdist_pallas(J(q), J(cand), block_b=16,
                                        block_m=128, interpret=True)):
        if quantised:
            np.testing.assert_array_equal(got, np.asarray(want))
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("mode", ["attraction", "repulsion"])
def test_ne_forces_plain_vs_jax_ref_and_interpret(mode):
    rng = np.random.default_rng(9)
    b, k, d = 48, 13, 2
    y = rng.normal(0, 3, (b, d)).astype(np.float32)
    nbr = rng.normal(0, 3, (b, k, d)).astype(np.float32)
    nbr[:, 1] = nbr[:, 0]                    # duplicate neighbours
    coef = rng.uniform(0, 1, (b, k)).astype(np.float32)
    coef[rng.random((b, k)) < 0.1] = 0.0
    alpha = np.float32(0.7)
    got = ne_forces(T(y), T(nbr), T(coef), torch.tensor(alpha), mode=mode)
    for want in (j_forces_ref(J(y), J(nbr), J(coef), alpha, mode=mode),
                 ne_forces_pallas(J(y), J(nbr), J(coef), alpha, mode=mode,
                                  block_b=16, interpret=True)):
        for g, w in zip(got, want):
            _close(g.numpy(), w)


def test_ne_forces_gather_plain_vs_jax_ref_and_interpret():
    """Three segments with the negatives' edges not emitted, as the
    scatter_fused=False path calls it, and out-of-range / SENTINEL ids."""
    rng = np.random.default_rng(11)
    n, b, d = 80, 48, 2
    y = rng.normal(0, 3, (n, d)).astype(np.float32)
    qid = rng.integers(-2, n + 2, b).astype(np.int32)
    segments = (("attraction", 6), ("repulsion", 4), ("repulsion", 3))
    emit = (True, True, False)
    nbr = rng.integers(-3, n + 3, (b, 13)).astype(np.int32)
    nbr[rng.random((b, 13)) < 0.05] = SENTINEL
    coef = rng.uniform(0, 1, (b, 13)).astype(np.float32)
    coef[rng.random((b, 13)) < 0.1] = 0.0
    alpha = np.float32(1.3)
    got = ne_forces_gather(T(y), T(qid), T(nbr), T(coef), torch.tensor(alpha),
                           segments=segments, emit_edges=emit)
    assert got[1][2] is None
    for want in (j_gather_ref(J(y), J(qid), J(nbr), J(coef), alpha,
                              segments=segments, emit_edges=emit),
                 ne_forces_gather_pallas(J(y), J(qid), J(nbr), J(coef), alpha,
                                         segments=segments, emit_edges=emit,
                                         block_b=16, interpret=True)):
        assert want[1][2] is None
        for g_all, w_all in zip(got, want):
            for g, w in zip(g_all, w_all):
                if w is not None:
                    _close(g.numpy(), w)


def test_new_wrappers_dispatch_on_device():
    """CPU tensors run the plain versions and count no launch; tensors on
    another device raise instead of falling back."""
    before = dict(kernels.LAUNCHES)
    y = torch.zeros((4, 2))
    nbr = torch.zeros((4, 3, 2))
    coef = torch.ones((4, 3))
    alpha = torch.tensor(1.0)
    ids = torch.arange(4, dtype=torch.int32)
    pairwise_sqdist(y, nbr)
    ne_forces(y, nbr, coef, alpha, mode="repulsion")
    ne_forces_gather(y, ids, ids[:, None].repeat(1, 3), coef, alpha,
                     segments=(("attraction", 2), ("repulsion", 1)),
                     emit_edges=(True, False))
    assert kernels.LAUNCHES == before
    meta = [t.to("meta") for t in (y, nbr, coef, alpha)]
    with pytest.raises(ValueError, match="device"):
        pairwise_sqdist(meta[0], meta[1])
    with pytest.raises(ValueError, match="device"):
        ne_forces(*meta, mode="attraction")
    with pytest.raises(ValueError, match="mode"):
        ne_forces(y, nbr, coef, alpha, mode="sideways")
    with pytest.raises(ValueError, match="add up"):
        ne_forces_gather(y, ids, ids[:, None].repeat(1, 3), coef, alpha,
                         segments=(("attraction", 2),), emit_edges=(True,))


# --------------------------------------------------------------------------
# Reverse edges: exact


def test_counter_fill_bit_exact():
    for salt in (0, -7, 123456789):
        want = j_knn.counter_fill(jnp.int32(salt), 300, 5)
        got = t_knn.counter_fill(torch.tensor(salt, dtype=torch.int32), 300, 5)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("r", [1, 4])
def test_reverse_neighbors_exact(r):
    """Rows nobody lists get all fill, rows listed more than r times keep
    their first r sources, and SENTINEL entries are edges to nobody."""
    rng = np.random.default_rng(r)
    n, k = 60, 6
    idx = rng.integers(0, n // 2, (n, k)).astype(np.int32)  # upper half unlisted
    idx[:, 0] = 3                            # row 3 listed by everyone
    idx[rng.random((n, k)) < 0.1] = SENTINEL
    fill = np.array(j_knn.counter_fill(jnp.int32(99), n, r))
    want = np.asarray(j_knn.reverse_neighbors(J(idx), n, r, fill=J(fill)))
    got = t_knn.reverse_neighbors(T(idx), n, r, fill=T(fill))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the cases are there: unlisted rows are all fill (the last row also
    # collects the SENTINEL edges), row 3 keeps its first r sources
    np.testing.assert_array_equal(want[n // 2:-1], fill[n // 2:-1])
    sources = np.nonzero(idx.reshape(-1) == 3)[0] // k
    assert len(sources) > r
    np.testing.assert_array_equal(want[3], sources[:r])


def test_state_bridge_round_trip_with_reverse_cache():
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(n=60, c_hd_rev=4,
                                                  rev_refresh=2)
    jst = jax.jit(lambda s, x, h: jf.funcsne_step(jcfg, s, x, h))(
        jst, J(X), jhp)
    a = _fields(jst)
    assert a["rev_idx"].shape == (60, 4) and a["rev_idx"].any()
    assert int(a["rev_step"]) == 0
    back = convert.state_to_numpy(convert.state_from_numpy(a, tcfg, "cpu"))
    for name in a:
        np.testing.assert_array_equal(back[name], a[name], err_msg=name)
        assert back[name].dtype == a[name].dtype, name


# --------------------------------------------------------------------------
# Step and chunk parity


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unfused_one_step_matches_jax(name):
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(**CONFIGS[name])
    jst1 = jax.jit(lambda s, x, h: jf.funcsne_step(jcfg, s, x, h))(
        jst, J(X), jhp)
    tst1 = tf.funcsne_step(tcfg, tst, T(X), thp)
    _assert_states_match(jst1, tst1)
    # step 0's gate always fires: the HD lists merged, the table was built
    assert (np.asarray(jst1.hd_idx) != np.asarray(jst.hd_idx)).any()
    if tcfg.c_hd_rev:
        assert int(tst1.rev_step) == 0 and bool(tst1.rev_idx.any())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unfused_chunk_of_ten_matches_jax(name):
    """A T=10 chunk with default_schedule, started where the gate both
    fires and skips, so the reverse table's cadence counts from its last
    rebuild across skipped steps."""
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(seed=1, **CONFIGS[name])
    jst = jst._replace(ema_new_frac=jnp.float32(0.3))
    tst = tst._replace(ema_new_frac=torch.tensor(0.3))
    jchunk = jf.make_chunked_step(jcfg, 10, schedule=jf.default_schedule,
                                  n_iter=10)
    jst_c, _, jm = jchunk(jax.tree.map(jnp.array, jst), J(X), jhp)
    tchunk = tf.make_chunked_step(tcfg, 10, schedule=tf.default_schedule,
                                  n_iter=10)
    tst_c, _, tm = tchunk(tst, T(X), thp)
    _assert_states_match(jst_c, tst_c)
    assert int(tm.step) == int(jm.step) == 10
    assert int(tm.bad_step) == int(jm.bad_step) == -1
    if tcfg.c_hd_rev:
        assert int(tst_c.rev_step) >= 0     # rebuilt at least once


@pytest.mark.parametrize("flag", ["scatter_fused", "gather_fused"])
def test_unfused_symmetrisation_conserves_momentum(flag):
    """With no negatives every edge acts on both endpoints, so the
    displacement field of the index_add_ symmetrisation sums to ~0; with
    negatives (never scattered back) it does not."""
    for n_neg, conserved in ((0, True), (16, False)):
        X, _, tcfg, _, thp, _, st = _problem(n=52, n_negatives=n_neg,
                                             **{flag: False})
        st = st._replace(vel=torch.zeros_like(st.vel),
                         gains=torch.ones_like(st.gains))
        out = tf._forces_update(tcfg, st, thp, t_knn.key_salt(st.rng),
                                tf.KERNELS)
        dY = (out.Y - st.Y).double().numpy()
        budget = np.abs(dY).sum() + 1e-6
        drift = np.abs(dY.sum(axis=0)).max()
        if conserved:
            assert drift < 1e-5 * budget, (drift, budget)
        else:
            assert drift > 1e-4 * budget, (drift, budget)


# which entry points of ``Ops`` a step of each path calls (the gate fires)
PATH_OPS = {
    "default": {"knn_merge_cand", "ne_forces_scatter"},
    "gather_off": {"pairwise_sqdist", "ne_forces", "segment_sum"},
    "scatter_off": {"knn_merge_cand", "ne_forces_gather", "segment_sum"},
    "merge_off": {"pairwise_sqdist_gather", "ne_forces_scatter"},
    "rev_refresh1": {"knn_merge_cand", "ne_forces_scatter"},
    "rev_refresh10": {"knn_merge_cand", "ne_forces_scatter"},
    "rev_gather_off": {"pairwise_sqdist", "ne_forces", "segment_sum"},
}


@pytest.mark.parametrize("name", list(PATH_OPS))
def test_flag_paths_call_their_own_kernels(name):
    """A step of each path goes through its kernels' entry points and no
    others (``chip_smoke.py`` checks the same on the card's launch
    counters)."""
    _, _, tcfg, _, thp, _, st = _problem(n=60, **CONFIGS.get(name, {}))
    called = []

    def rec(op, fn):
        def f(*args, **kw):
            called.append(op)
            return fn(*args, **kw)
        return f
    ops = tf.Ops(*[rec(op, fn) for op, fn in zip(tf.Ops._fields, tf.PLAIN)])
    X = torch.zeros((60, 12))
    tf.funcsne_step(tcfg, st, X, thp, ops=ops)
    assert set(called) == PATH_OPS[name]
    if name == "gather_off":
        assert called.count("ne_forces") == 3
