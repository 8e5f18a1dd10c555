"""The repairs of ROADMAP queue C against the JAX package on the CPU.

  C1  no width cap: 10-step chunks at dim_ld 8 and 32 (default, scatter-
      and gather-unfused paths) match JAX's as the d = 2 chunks do; the
      card's merge kernels keep a stated bound (K <= 1024, C <= 128) that
      ``validate_inputs`` raises before any launch.
  C2  JAX's return shapes: the chunk returns (state, snapshots, metrics)
      with ``n_snapshots``, ``fit`` returns (state, snapshots); the
      snapshots equal JAX's, and chunk(a) + chunk(b) equals chunk(a + b)
      bit for bit, snapshots included.
  C3  a deterministic symmetrisation: ``segment_sum`` adds each row's
      terms in increasing edge order (what the CUDA kernel does), which is
      the old sequential ``index_add_`` bit for bit on the CPU.
Tolerances as ``tests/test_torch_step.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import funcsne as jf  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.kernels.segment_sum.ops import segment_runs, segment_sum  # noqa: E402
from test_torch_step import F_ATOL, F_RTOL, _assert_states_match, _problem  # noqa: E402

torch.set_num_threads(1)


def _jcopy(st):
    return jax.tree.map(jnp.array, st)


# --------------------------------------------------------------------------
# C1


# (flags, steps).  PCA needs dim_hd >= dim_ld, so the 32-wide case embeds
# 40-D blobs; there, at step 4, one row's LD slots 9 and 10 hold
# distances 8.784507 and 8.784510 in JAX and the port orders them the
# other way (3e-7 relative: float32 rounding decides a near-tie, as
# ROADMAP's observations record), after which the candidates drawn by slot
# differ.  So that case compares the 3 steps before the tie.
WIDE = {"d8": (dict(dim_ld=8), 10), "d32": (dict(dim_ld=32, m=40), 3),
        "d8_scatter_off": (dict(dim_ld=8, scatter_fused=False), 10),
        "d8_gather_off": (dict(dim_ld=8, gather_fused=False), 10)}


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_embedding_chunk_of_ten_matches_jax(name):
    flags, T = WIDE[name]
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(seed=1, **flags)
    jst = jst._replace(ema_new_frac=jnp.float32(0.3))
    tst = tst._replace(ema_new_frac=torch.tensor(0.3))
    jchunk = jf.make_chunked_step(jcfg, T, schedule=jf.default_schedule,
                                  n_iter=10)
    jst_c, _, jm = jchunk(_jcopy(jst), jnp.asarray(X), jhp)
    tchunk = tf.make_chunked_step(tcfg, T, schedule=tf.default_schedule,
                                  n_iter=10)
    tst_c, _, tm = tchunk(tst, torch.from_numpy(X), thp)
    assert tst_c.Y.shape == (X.shape[0], tcfg.dim_ld)
    _assert_states_match(jst_c, tst_c)
    assert int(tm.step) == int(jm.step) == T


def test_card_bounds_are_stated_and_raised():
    ok = tf.FuncSNEConfig(n_points=5000, dim_hd=8, dim_ld=64, k_hd=1024,
                          k_ld=1024, c_hd_non=100, c_hd_rev=20, c_ld_non=124)
    tf.check_card_bounds(ok)
    for bad, what in ((dict(k_hd=1025), "k_hd"), (dict(k_ld=2000), "k_ld"),
                      (dict(c_hd_non=125), "HD candidates"),
                      (dict(c_ld_rand=125), "LD candidates")):
        cfg = tf.FuncSNEConfig(n_points=5000, dim_hd=8, **bad)
        with pytest.raises(ValueError, match=what) as e:
            tf.check_card_bounds(cfg)
        assert "1024" in str(e.value) and "128" in str(e.value)


# --------------------------------------------------------------------------
# C2


def test_fit_snapshots_match_jax():
    """9 steps in chunks of 4, 4 and 1, so the captures at steps 3, 6 and 9
    cross chunk boundaries, on the parity tests' standard problem (n =
    160).  (At n = 120 an LD near-tie swaps two slots at step 6 in the
    plain step-by-step runs as well, the ROADMAP observation; from there
    the trajectories part.)"""
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem()
    jst_f, jsnaps = jf.fit(jnp.asarray(X), cfg=jcfg, n_iter=9, hparams=jhp,
                           state=_jcopy(jst), snapshot_every=3, chunk_size=4)
    tst_f, tsnaps = tf.fit(X, cfg=tcfg, n_iter=9, hparams=thp, state=tst,
                           snapshot_every=3, chunk_size=4, device="cpu")
    assert len(tsnaps) == len(jsnaps) == 3
    for a, b in zip(tsnaps, jsnaps):
        assert isinstance(a, np.ndarray) and a.shape == (160, 2)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=F_RTOL * np.abs(b).max() + F_ATOL)
    np.testing.assert_array_equal(tsnaps[-1], tst_f.Y.numpy())
    _assert_states_match(jst_f, tst_f)
    _, none = tf.fit(X, cfg=tcfg, n_iter=3, hparams=thp, state=tst,
                     device="cpu")
    assert none == []


def test_chunk_snapshot_ring_matches_jax():
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(n=100)
    jchunk = jf.make_chunked_step(jcfg, 10, schedule=jf.default_schedule,
                                  n_iter=20, snapshot_every=4)
    jst_c, jsn, jm = jchunk(_jcopy(jst), jnp.asarray(X), jhp)
    tchunk = tf.make_chunked_step(tcfg, 10, schedule=tf.default_schedule,
                                  n_iter=20, snapshot_every=4)
    tst_c, tsn, tm = tchunk(tst, torch.from_numpy(X), thp)
    assert tuple(tsn.shape) == jsn.shape == (3, 100, 2)
    assert int(tm.n_snapshots) == int(jm.n_snapshots) == 2
    for i in range(2):
        want = np.asarray(jsn[i])
        np.testing.assert_allclose(tsn[i].numpy(), want, rtol=0,
                                   atol=F_RTOL * np.abs(want).max() + F_ATOL)
    assert not tsn[2].any()
    _, off, m0 = tf.make_chunked_step(tcfg, 3)(tst, torch.from_numpy(X), thp)
    assert tuple(off.shape) == (0, 100, 2) and int(m0.n_snapshots) == 0


def test_chunks_compose_bit_for_bit_with_snapshots():
    X, _, tcfg, _, thp, _, tst = _problem(n=90, seed=2)
    Xt = torch.from_numpy(X)

    def run(sizes):
        st, taken = tst, []
        for T in sizes:
            st, sn, m = tf.make_chunked_step(
                tcfg, T, schedule=tf.default_schedule, n_iter=20,
                snapshot_every=5)(st, Xt, thp)
            taken.extend(sn[:int(m.n_snapshots)])
        return st, taken
    whole, snaps_whole = run([20])
    parts, snaps_parts = run([7, 13])
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
    assert len(snaps_whole) == len(snaps_parts) == 4
    for a, b in zip(snaps_whole, snaps_parts):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# C3


def _rows(seed, n=50, e=4000, d=3, integer=False):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, n, e))
    if integer:      # exactly representable partial sums
        val = torch.from_numpy(rng.integers(-64, 65, (e, d)).astype(np.float32))
    else:
        val = torch.from_numpy((rng.normal(size=(e, d))
                                * np.exp(rng.normal(size=(e, 1)) * 2))
                               .astype(np.float32))
    return idx, val, n


def test_segment_sum_is_the_sequential_index_add():
    """The step's old symmetrisation (three index_add_ calls: rows, HD
    edges, LD edges) and the new one segment sum agree bit for bit on the
    CPU, and both are the sum in increasing edge order within float32."""
    idx, val, n = _rows(0)
    parts = np.array_split(np.arange(idx.shape[0]), 3)
    old = torch.zeros((n, 3))
    for p in parts:
        old.index_add_(0, idx[p], val[p])
    new = segment_sum(idx, val, n)
    assert torch.equal(new, old)
    # the card's algorithm, in python: the wrapper's stable order and run
    # starts, then each row's run walked in order as the kernel does
    perm, offs = segment_runs(idx, n)
    assert torch.equal(perm, torch.sort(idx, stable=True).indices)
    seq = torch.zeros((n, 3))
    for row in range(n):
        for e in perm[offs[row]:offs[row + 1]].tolist():
            assert idx[e] == row
            seq[row] += val[e]
    assert torch.equal(new, seq)
    exact = torch.zeros((n, 3), dtype=torch.float64).index_add_(
        0, idx, val.double())
    np.testing.assert_allclose(new.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-5 * float(exact.abs().max()))


def test_segment_sum_independent_of_edge_order_where_exact():
    idx, val, n = _rows(1, integer=True)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(idx.shape[0]))
    a = segment_sum(idx, val, n)
    assert torch.equal(a, segment_sum(idx[perm], val[perm], n))
    exact = torch.zeros((n, 3), dtype=torch.float64).index_add_(
        0, idx, val.double())
    assert torch.equal(a.double(), exact)
