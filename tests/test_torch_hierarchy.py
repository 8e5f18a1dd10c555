"""The port's DBSCAN, eps selection, cluster graph and alpha sweep against
the JAX package's.

DBSCAN runs on quantised snapshots (quarter-integers), where both
packages' squared distances are exact, so the labels must be equal:
core points, the bounded min-label propagation (``ceil(log2 N) + 2``
sweeps, so a long chain keeps several labels), borders by their nearest
core (first index on a tie) and noise.  The port's row-blocked sweeps
must give the dense result at any block size.  ``select_eps`` and
``cluster_graph_edges`` are numpy in both packages and must be equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dbscan as jd  # noqa: E402
from repro.core import funcsne as jf  # noqa: E402
from repro.core import hierarchy as jh  # noqa: E402
from repro.data.synthetic import blobs  # noqa: E402
from repro_torch.core import dbscan as td  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core import hierarchy as th  # noqa: E402

torch.set_num_threads(1)


def _snapshot(n=300, seed=0, n_centers=5, noise=20):
    """Quarter-grid 2-D blobs plus uniform noise rows."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-40, 41, (n_centers, 2))
    lab = rng.integers(0, n_centers, n - noise)
    y = np.concatenate([centers[lab] + rng.integers(-6, 7, (n - noise, 2)),
                        rng.integers(-60, 61, (noise, 2))])
    return (y / 4.0).astype(np.float32)


def _chain(length=40, extra_noise=6):
    """A line of core points 1 apart (eps 1, min_pts 3: each interior
    point has itself and two neighbours), two border points beside it,
    its two ends (border: 2 within eps) and isolated noise."""
    pts = [(float(i), 0.0) for i in range(length)]
    pts += [(10.0, 0.75), (25.0, -1.0)]
    pts += [(100.0 + 10 * i, 50.0) for i in range(extra_noise)]
    return np.asarray(pts, np.float32)


def _labels_jax(Y, eps, min_pts, max_sweeps=0):
    return np.asarray(jd.dbscan(jnp.asarray(Y), eps, min_pts, max_sweeps))


@pytest.mark.parametrize("eps,min_pts", [(1.0, 5), (1.5, 5), (2.25, 8),
                                         (0.5, 2), (0.0, 1), (40.0, 5)])
def test_dbscan_labels_exact(eps, min_pts):
    Y = _snapshot()
    got = td.dbscan(torch.from_numpy(Y), eps, min_pts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _labels_jax(Y, eps, min_pts))


def test_dbscan_chain_longer_than_the_sweeps():
    Y = _chain()
    n = Y.shape[0]
    sweeps = td.max_sweeps_of(n)
    assert sweeps == int(jnp.ceil(jnp.log2(n))) + 2 == 8
    want = _labels_jax(Y, 1.0, 3)
    got = td.dbscan(torch.from_numpy(Y), 1.0, 3).numpy()
    np.testing.assert_array_equal(got, want)
    chain = want[:40]
    # the propagation stops after 8 sweeps: the chain keeps several labels
    assert len(np.unique(chain)) > 1, chain
    assert (want[-6:] == -1).all()                 # isolated noise
    core_label = {i: want[i] for i in range(1, 39)}
    assert want[40] == core_label[10]              # border beside row 10
    assert want[0] == want[1] and want[39] == want[38]   # ends are borders
    # enough sweeps join the chain into one cluster, in both packages
    full = td.dbscan(torch.from_numpy(Y), 1.0, 3, max_sweeps=64).numpy()
    np.testing.assert_array_equal(full, _labels_jax(Y, 1.0, 3, 64))
    assert len(np.unique(full[:40])) == 1


def test_dbscan_border_tie_takes_the_first_core():
    """A border point equidistant from two cores of different clusters
    takes the lower index's label (argmin's first index)."""
    left = [(-3.0 - i, 0.0) for i in range(4)]
    right = [(3.0 + i, 0.0) for i in range(4)]
    Y = np.asarray(left + right + [(0.0, 0.0)], np.float32)
    # min_pts 4: the end points are core, the middle one (itself and one
    # core on each side) a border
    want = _labels_jax(Y, 3.0, 4)
    got = td.dbscan(torch.from_numpy(Y), 3.0, 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-1] == got[0] != got[4]


@pytest.mark.parametrize("block", [1, 7, 64, 299, 300])
def test_dbscan_blocked_equals_dense(monkeypatch, block):
    Y = _snapshot(seed=1)
    for eps, min_pts in ((1.5, 5), (0.75, 3)):
        dense = td.dbscan(torch.from_numpy(Y), eps, min_pts).numpy()
        monkeypatch.setattr(td, "BLOCK_ROWS", block)
        got = td.dbscan(torch.from_numpy(Y), eps, min_pts).numpy()
        monkeypatch.undo()
        np.testing.assert_array_equal(got, dense)
        np.testing.assert_array_equal(got, _labels_jax(Y, eps, min_pts))
    monkeypatch.setattr(td, "BLOCK_ROWS", block)
    Yc = _chain()
    np.testing.assert_array_equal(td.dbscan(torch.from_numpy(Yc), 1.0, 3),
                                  _labels_jax(Yc, 1.0, 3))


def test_max_sweeps_in_float32_as_jnp():
    n = np.arange(1, 200_001)
    want = np.asarray(jnp.ceil(jnp.log2(jnp.asarray(n, jnp.int32)))) + 2
    for i in (1, 2, 3, 4, 5, 63, 64, 65, 1024, 1025, 65536, 65537, 70_000,
              131_072, 131_073, 200_000):
        assert td.max_sweeps_of(i) == int(want[i - 1]), i


def test_relabel_compact_exact():
    rng = np.random.default_rng(3)
    for lab in (rng.integers(-1, 40, 500), np.full(10, -1),
                np.array([7, 7, 3, -1, 12, 3]), _labels_jax(_chain(), 1.0, 3)):
        got, k = td.relabel_compact(torch.from_numpy(np.array(lab)))
        want, kw = jd.relabel_compact(jnp.asarray(lab))
        assert k == kw
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        got_np, k_np = td.relabel_compact(np.asarray(lab))
        np.testing.assert_array_equal(got_np, want)


def test_select_eps_exact():
    Y = _snapshot(n=900, seed=2) * 1.37
    for q, rows, seed in ((0.02, 1024, 0), (0.05, 256, 3), (0.02, 128, 7),
                          (0.5, 10 ** 6, 1)):
        assert th.select_eps(Y, q, max_rows=rows, seed=seed) \
            == jh.select_eps(Y, q, max_rows=rows, seed=seed)
    Z = np.zeros((64, 2), np.float32)
    assert th.select_eps(Z, 0.02, max_rows=32) \
        == jh.select_eps(Z, 0.02, max_rows=32) == 0.0


def test_cluster_graph_edges_exact():
    rng = np.random.default_rng(4)
    levels_t, levels_j = [], []
    for li, k in enumerate((3, 5, 8)):
        lab = rng.integers(-1, k, 400).astype(np.int32)
        sizes = [int(np.sum(lab == i)) for i in range(k)]
        levels_t.append(th.HierarchyLevel(1.0 / (li + 1), lab, k, sizes))
        levels_j.append(jh.HierarchyLevel(1.0 / (li + 1), lab, k, sizes))
    for w in (0.1, 0.3):
        got = th.cluster_graph_edges(levels_t, w)
        assert got == jh.cluster_graph_edges(levels_j, w)
    graph = th.ClusterGraph(levels_t, th.cluster_graph_edges(levels_t))
    assert graph.summary() == jh.ClusterGraph(
        levels_j, jh.cluster_graph_edges(levels_j)).summary()


# --------------------------------------------------------------------------
# extract_hierarchy


def _hierarchy_problem(n=120, dim=8, seed=0, center_std=8.0):
    X, _ = blobs(n=n, dim=dim, n_centers=3, center_std=center_std, seed=seed)
    return X


def test_extract_hierarchy_chunk_size_invariant():
    """Chunk boundaries never change the numbers: any chunk_size gives the
    identical cluster graph, labels included."""
    X = _hierarchy_problem()
    kw = dict(alphas=(1.0, 0.6), warmup_iters=25, iters_per_level=20,
              cfg=tf.FuncSNEConfig(n_points=120, dim_hd=8, dim_ld=2),
              device="cpu")
    g_a = th.extract_hierarchy(X, chunk_size=7, **kw)
    g_b = th.extract_hierarchy(X, chunk_size=50, **kw)
    assert len(g_a.levels) == len(g_b.levels) == 2
    for la, lb in zip(g_a.levels, g_b.levels):
        assert la.n_clusters == lb.n_clusters
        np.testing.assert_array_equal(la.labels, lb.labels)
    assert g_a.edges == g_b.edges


def test_extract_hierarchy_labels_match_jax():
    """The JAX test's well-separated problem (PCA init of three blobs is
    crisply clustered already): both packages' sweeps give the same labels
    at every level, ragged chunks (6 = 4+2, 5 = 4+1) included."""
    X = _hierarchy_problem(seed=2, center_std=10.0)
    kw = dict(alphas=(1.0, 0.8), warmup_iters=6, iters_per_level=5,
              eps_quantile=0.05, chunk_size=4)
    want = jh.extract_hierarchy(
        X, cfg=jf.FuncSNEConfig(n_points=120, dim_hd=8, dim_ld=2,
                                backend="xla"),
        hparams=jf.default_hparams(120, perplexity=10.0), **kw)
    got = th.extract_hierarchy(
        X, cfg=tf.FuncSNEConfig(n_points=120, dim_hd=8, dim_ld=2),
        hparams=tf.default_hparams(120, perplexity=10.0, device="cpu"),
        device="cpu", **kw)
    assert len(got.levels) == len(want.levels) == 2
    assert got.levels[0].n_clusters >= 3
    for lt, lj in zip(got.levels, want.levels):
        assert lt.alpha == lj.alpha
        assert lt.n_clusters == lj.n_clusters
        assert lt.sizes == lj.sizes
        np.testing.assert_array_equal(lt.labels, lj.labels)
    assert got.edges == want.edges


def test_extract_hierarchy_default_width_and_dbscan_fn():
    """The default config embeds in 4-D; ``dbscan_fn`` gets each level's
    snapshot as a tensor on the run's device."""
    X = _hierarchy_problem(n=90, seed=5)
    seen = []

    def fn(Y, eps, min_pts):
        seen.append((tuple(Y.shape), Y.device.type, eps, min_pts))
        return td.dbscan(Y, eps, min_pts)
    g = th.extract_hierarchy(X, alphas=(2.0, 1.0, 0.5), warmup_iters=10,
                             iters_per_level=5, dbscan_fn=fn, min_pts=4,
                             device="cpu")
    assert [s[:2] for s in seen] == [((90, 4), "cpu")] * 3
    assert all(s[3] == 4 and s[2] > 0 for s in seen)
    assert [lv.alpha for lv in g.levels] == [2.0, 1.0, 0.5]
    assert all(sum(lv.sizes) + int(np.sum(lv.labels == -1)) == 90
               for lv in g.levels)
