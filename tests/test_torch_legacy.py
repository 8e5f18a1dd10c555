"""FUnc-SNE's ``cand_fused=False`` path and B4 against the JAX package.

With ``cand_fused=False`` the gate, the candidates, the negatives and the
reverse-table fill are threefry draws (``repro_torch.core.threefry``), and
the HD and LD merges run B4 (``knn_merge``) on the precomputed candidate
block.  Checked here:

  * B4's plain version against the JAX ``knn_merge_ref``,
    ``knn_merge_rank_ref`` and ``knn_merge_pallas`` in interpret mode, in HD
    and LD-rescore mode, with SENTINEL, duplicate, self, inactive and
    out-of-range candidates (scored at the clipped id, merged raw): ids,
    distances and flags exact on quantised rows;
  * one step and one T=10 chunk from one bridged state, alone and with each
    flag path, against JAX ``backend="xla"``: gates, ids, flags and the
    reverse cache exact, floats within the tolerances of
    ``tests/test_torch_step.py``;
  * which kernel entry points each path's step calls.

The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import funcsne as jf  # noqa: E402
from repro.core import knn as j_knn  # noqa: E402
from repro.kernels.knn_merge.kernel import knn_merge_pallas  # noqa: E402
from repro.kernels.knn_merge.ref import knn_merge_rank_ref, knn_merge_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.kernels.knn_merge.ops import knn_merge  # noqa: E402
from test_torch_step import _assert_states_match, _fields, _problem  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
J = jnp.asarray
SENTINEL = int(j_knn.SENTINEL)

# cand_fused=False alone and with each flag path of the counter-RNG slice
CONFIGS = {
    "legacy": dict(),
    "gather_off": dict(gather_fused=False),
    "scatter_off": dict(scatter_fused=False),
    "merge_off": dict(merge_fused=False),
    "rev_refresh1": dict(c_hd_rev=4, rev_refresh=1),
    "rev_refresh10": dict(c_hd_rev=4, rev_refresh=10),
}


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


# --------------------------------------------------------------------------
# B4's plain version


def _b4_problem(seed, rescore, n=70, b=40, k=8, c=9):
    """Quantised rows with many ties; duplicate-free current lists sorted by
    exact distance with SENTINEL tails; candidates with an earlier
    duplicate, a current entry, the row itself, SENTINEL and out-of-range
    ids; an activity mask."""
    rng = np.random.default_rng(seed)
    m = 2 if rescore else 13
    x = (rng.integers(-3, 4, (n, m)) / 4.0).astype(np.float32)
    qid = rng.permutation(n)[:b].astype(np.int32)
    cur = np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(np.int32)
    d = ((x[cur] - x[qid][:, None]) ** 2).sum(-1).astype(np.float32)
    sent = np.sort(rng.random((b, k)) < 0.2, axis=1)
    cur[sent], d[sent] = SENTINEL, np.inf
    order = np.argsort(d, axis=1, kind="stable")
    cur, d = (np.take_along_axis(cur, order, 1),
              np.take_along_axis(d, order, 1))
    cand = rng.integers(-2, n + 2, (b, c)).astype(np.int32)
    cand[:, 1] = cand[:, 0]
    cand[:, 2] = cur[:, 0]
    cand[:, 3] = qid
    cand[rng.random((b, c)) < 0.1] = SENTINEL
    active = rng.random((b, c)) >= 0.15
    cur_valid = (cur != SENTINEL) & (rng.random((b, k)) >= 0.1)
    return x, qid, cur, d, cand, active, cur_valid


@pytest.mark.parametrize("rescore", [False, True])
@pytest.mark.parametrize("with_active", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_knn_merge_plain_vs_jax_refs_and_interpret(rescore, with_active, seed):
    x, qid, cur, d, cand, active, cur_valid = _b4_problem(seed, rescore)
    ca = active if with_active else None
    cur_d = None if rescore else d
    cv = cur_valid if rescore else None
    got = knn_merge(T(x), T(qid), T(cur), None if rescore else T(cur_d),
                    T(cand), cand_active=None if ca is None else T(ca),
                    cur_valid=None if cv is None else T(cv))
    assert [g.dtype for g in got] == [torch.int32, torch.float32, torch.bool]
    jargs = (J(x), J(qid), J(cur), None if rescore else J(cur_d), J(cand))
    jkw = dict(cand_active=None if ca is None else J(ca),
               cur_valid=None if cv is None else J(cv))
    kern = knn_merge_pallas(
        J(x), J(qid), J(cur), J(cv) if rescore else J(cur_d), J(cand),
        J(ca) if ca is not None else jnp.ones(cand.shape, bool),
        rescore=rescore, block_b=16, block_m=8, interpret=True)
    for want, label in ((knn_merge_ref(*jargs, **jkw), "ref"),
                        (knn_merge_rank_ref(*jargs, **jkw), "rank_ref"),
                        (kern, "interpret")):
        for g, w, name in zip(got, want, ("idx", "d", "improved")):
            _eq(g.numpy(), w, f"{label}:{name}")
    new_idx, new_d = got[0].numpy(), got[1].numpy()
    assert (new_d[:, 1:] >= new_d[:, :-1]).all()
    assert (new_idx != cur).any() and got[2].any()
    # an out-of-range candidate that entered the list keeps its raw id
    raw = (cand < 0) | ((cand >= x.shape[0]) & (cand != SENTINEL))
    entered = [set(r) for r in new_idx]
    assert any(int(v) in entered[i] for i, row in enumerate(cand)
               for v, bad in zip(row, raw[i]) if bad)


def test_knn_merge_wrapper_dispatch_and_checks():
    """A CPU tensor runs the plain version and counts no launch; a tensor
    elsewhere raises instead of falling back; the mode must be given."""
    x, qid, cur, d, cand, active, _ = _b4_problem(2, False)
    before = dict(kernels.LAUNCHES)
    knn_merge(T(x), T(qid), T(cur), T(d), T(cand), cand_active=T(active))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        knn_merge(*(t.to("meta") for t in (T(x), T(qid), T(cur), T(d),
                                           T(cand))))
    with pytest.raises(ValueError, match="rescore"):
        knn_merge(T(x), T(qid), T(cur), None, T(cand))


# --------------------------------------------------------------------------
# Step and chunk parity


@pytest.mark.parametrize("name", list(CONFIGS))
def test_legacy_one_step_matches_jax(name):
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(cand_fused=False,
                                                  **CONFIGS[name])
    jst1 = jax.jit(lambda s, x, h: jf.funcsne_step(jcfg, s, x, h))(
        jst, J(X), jhp)
    tst1 = tf.funcsne_step(tcfg, tst, T(X), thp)
    _assert_states_match(jst1, tst1)
    # the gate fired (E[N_new/N] = 1 at step 0 gives p = 1) and merged
    assert (np.asarray(jst1.hd_idx) != np.asarray(jst.hd_idx)).any()
    if tcfg.c_hd_rev:
        assert int(tst1.rev_step) == 0 and bool(tst1.rev_idx.any())


def _gate(rng_words, step, ema):
    """The threefry refinement gate, as the JAX step draws it."""
    key = jax.random.fold_in(jnp.asarray(rng_words, jnp.uint32), step)
    r_gate = jax.random.split(key, 4)[0]
    p = jnp.clip(0.05 + 0.95 * jnp.float32(ema), 0.0, 1.0)
    return bool(jax.random.bernoulli(r_gate, p))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_legacy_chunk_of_ten_matches_jax(name):
    """A T=10 chunk with default_schedule from a low E[N_new/N], so the
    threefry gate both fires and skips and the reverse table's cadence
    counts across skipped steps."""
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(seed=1, cand_fused=False,
                                                  **CONFIGS[name])
    jst = jst._replace(ema_new_frac=jnp.float32(0.3))
    tst = tst._replace(ema_new_frac=torch.tensor(0.3))
    jchunk = jf.make_chunked_step(jcfg, 10, schedule=jf.default_schedule,
                                  n_iter=10)
    jst_c, _, jm = jchunk(jax.tree.map(jnp.array, jst), J(X), jhp)
    tchunk = tf.make_chunked_step(tcfg, 10, schedule=tf.default_schedule,
                                  n_iter=10)
    tst_c, tm = tchunk(tst, T(X), thp)
    _assert_states_match(jst_c, tst_c)
    assert int(tm.step) == int(jm.step) == 10
    assert int(tm.bad_step) == int(jm.bad_step) == -1
    if tcfg.c_hd_rev:
        assert int(tst_c.rev_step) >= 0


def test_legacy_gates_match_jax_step_by_step():
    """The port's threefry gate, drawn with ``core.threefry`` from the port's
    states, equals JAX's drawn from the JAX states, over ten steps that both
    fire and skip."""
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(seed=2, cand_fused=False)
    jst = jst._replace(ema_new_frac=jnp.float32(0.3))
    tst = tst._replace(ema_new_frac=torch.tensor(0.3))
    jstep = jax.jit(lambda s, x, h: jf.funcsne_step(jcfg, s, x, h))
    gates_j, gates_t = [], []
    for it in range(10):
        f = _fields(jst)
        gates_j.append(_gate(f["rng"], it, f["ema_new_frac"]))
        r_gate = threefry.split(threefry.fold_in(tst.rng, it), 4)[0]
        p = (0.05 + 0.95 * tst.ema_new_frac).clamp(0.0, 1.0)
        gates_t.append(bool(threefry.bernoulli(r_gate, p)))
        jst = jstep(jst, J(X), jhp)
        tst = tf.funcsne_step(tcfg, tst, T(X), thp)
    assert gates_t == gates_j
    assert any(gates_j) and not all(gates_j)
    _assert_states_match(jst, tst)


def test_fit_legacy_from_init_state_matches_jax_start():
    """``fit`` runs the path from its own start, which is the JAX start of
    ``PRNGKey(seed)``: the first step of both agrees."""
    X, jcfg, tcfg, jhp, thp, _, _ = _problem(n=100, cand_fused=False)
    jst = jf.init_state(jax.random.PRNGKey(4), J(X), jcfg, perplexity=20.0)
    jst = jax.jit(lambda s, x, h: jf.funcsne_step(jcfg, s, x, h))(
        jst, J(X), jf.default_schedule(0, 1, jhp))
    tst = tf.fit(X, cfg=tcfg, n_iter=1, seed=4, hparams=thp, device="cpu")
    a, b = _fields(jst), {k: v.numpy() for k, v in tst._asdict().items()}
    for name in ("hd_idx", "ld_idx", "new_flag", "step"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    assert np.isfinite(b["Y"]).all()


# which entry points of ``Ops`` a step of each path calls (the gate fires)
PATH_OPS = {
    "legacy": {"knn_merge", "ne_forces_scatter"},
    "gather_off": {"pairwise_sqdist", "ne_forces"},
    "scatter_off": {"knn_merge", "ne_forces_gather"},
    "merge_off": {"pairwise_sqdist_gather", "ne_forces_scatter"},
    "rev_refresh1": {"knn_merge", "ne_forces_scatter"},
    "rev_refresh10": {"knn_merge", "ne_forces_scatter"},
}


@pytest.mark.parametrize("name", list(PATH_OPS))
def test_legacy_paths_call_their_own_kernels(name):
    _, _, tcfg, _, thp, _, st = _problem(n=60, cand_fused=False,
                                         **CONFIGS[name])
    called = []

    def rec(op, fn):
        def f(*args, **kw):
            called.append(op)
            return fn(*args, **kw)
        return f
    ops = tf.Ops(*[rec(op, fn) for op, fn in zip(tf.Ops._fields, tf.PLAIN)])
    tf.funcsne_step(tcfg, st, torch.zeros((60, 12)), thp, ops=ops)
    assert set(called) == PATH_OPS[name]
    if PATH_OPS[name] >= {"knn_merge"}:
        assert called.count("knn_merge") == 2     # HD and LD
