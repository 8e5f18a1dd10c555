"""The port's nearest-neighbour descent (``repro_torch.core.nnd``) against
the JAX package's ``repro.core.nnd``.

NND draws its candidates with threefry (or the counter hash with
``cand_fused=True``) and merges them through B4 (B2, or the plain
dedup/merge), so on quantised X every setting tested gives the JAX lists,
distances and update history exactly:

  * ``nnd_init`` and one ``nnd_step`` (reverse table rebuilt in the step);
  * ``nnd(..., max_iter=10)``: ids, distances and ``history`` equal;
  * the recall test of ``tests/test_affinities_knn.py`` on the port;
  * which kernel entry points each setting calls, and that the entry
    points run on the card unless the caller asks for the CPU.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import nnd as jn  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core import nnd as tn  # noqa: E402
from repro_torch.core.quality import knn_set_quality  # noqa: E402
from repro_torch.data.synthetic import blobs  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
J = jnp.asarray

CONFIGS = {
    "defaults": dict(),
    "cand_fused": dict(cand_fused=True),
    "gather_off": dict(gather_fused=False),
    "merge_off": dict(merge_fused=False),
    "no_rev": dict(c_rev=0),
    "rev_refresh3": dict(rev_refresh=3),
}


def _x(seed=0, n=240, m=10):
    """Quantised clustered rows: exact distances, many ties."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-8, 9, (5, m))
    x = centers[rng.integers(0, 5, n)] + rng.integers(-3, 4, (n, m))
    return (x / 4.0).astype(np.float32)


def _cfgs(name, k=8):
    flags = CONFIGS[name]
    return (jn.NNDConfig(k=k, backend="xla", **flags),
            tn.NNDConfig(k=k, **flags))


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_nnd_init_and_step_exact(name):
    X = _x(1)
    jc, tc = _cfgs(name)
    key = jax.random.PRNGKey(11)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    ji, jd = jn.nnd_init(key, J(X), jc)
    ti, td = tn.nnd_init(tkey, X, tc, device="cpu")
    _eq(ti.numpy(), ji, "init idx")
    _eq(td.numpy(), jd, "init d")
    r = jax.random.fold_in(key, 0)
    ji, jd, jf_ = jn.nnd_step(r, J(X), ji, jd, jc)
    ti, td, tf_ = tn.nnd_step(torch.from_numpy(np.asarray(r).astype(np.int64)),
                              T(X), ti, td, tc, device="cpu")
    _eq(ti.numpy(), ji, "step idx")
    _eq(td.numpy(), jd, "step d")
    assert float(tf_) == float(jf_) and 0 < float(tf_) <= 1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_nnd_ten_iterations_exact(name):
    X = _x(2)
    jc, tc = _cfgs(name)
    ji, jd, jh = jn.nnd(J(X), jc, jax.random.PRNGKey(5), max_iter=10)
    ti, td, th = tn.nnd(X, tc, torch.tensor([0, 5]), max_iter=10,
                        device="cpu")
    _eq(ti.numpy(), ji, "idx")
    _eq(td.numpy(), jd, "d")
    assert th == jh and len(th) == 10


def test_nnd_default_key_and_tol_stop_exact():
    """``rng=None`` is ``PRNGKey(0)``; a loose ``tol`` stops both early at
    the same iteration."""
    X = _x(3, n=160)
    jc, tc = _cfgs("defaults")
    ji, _, jh = jn.nnd(J(X), jc, max_iter=40, tol=0.2)
    ti, _, th = tn.nnd(X, tc, max_iter=40, tol=0.2, device="cpu")
    _eq(ti.numpy(), ji, "idx")
    assert th == jh and len(th) < 40 and th[-1] < 0.2


def test_nnd_converges_on_overlapping_blobs():
    """The JAX package's recall test (``test_affinities_knn.py``) on the
    port."""
    X, _ = blobs(n=400, dim=16, n_centers=5, center_std=1.0, blob_std=1.0,
                 seed=0)
    idx, d, hist = tn.nnd(X, tn.NNDConfig(k=10), max_iter=50, device="cpu")
    q = float(knn_set_quality(idx, T(X)))
    assert q > 0.95, q


# which entry points of ``Ops`` each setting calls (init and one step)
PATH_OPS = {
    "defaults": {"pairwise_sqdist_gather", "knn_merge"},
    "cand_fused": {"pairwise_sqdist_gather", "knn_merge_cand"},
    "gather_off": {"pairwise_sqdist"},
    "merge_off": {"pairwise_sqdist_gather"},
    "no_rev": {"pairwise_sqdist_gather", "knn_merge"},
    "rev_refresh3": {"pairwise_sqdist_gather", "knn_merge"},
}


@pytest.mark.parametrize("name", list(PATH_OPS))
def test_nnd_calls_its_own_kernels(name):
    _, tc = _cfgs(name)
    called = []

    def rec(op, fn):
        def f(*args, **kw):
            called.append(op)
            return fn(*args, **kw)
        return f
    ops = tf.Ops(*[rec(op, fn) for op, fn in zip(tf.Ops._fields, tf.PLAIN)])
    _, _, hist = tn.nnd(_x(4, n=80), tc, max_iter=3, device="cpu", ops=ops)
    assert set(called) == PATH_OPS[name]
    if name == "defaults":       # B1 once, B4 once per iteration
        assert called.count("pairwise_sqdist_gather") == 1
        assert called.count("knn_merge") == len(hist) == 3


def test_nnd_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = _x(5, n=40)
    cfg = tn.NNDConfig(k=4)
    idx = torch.zeros((40, 4), dtype=torch.int32)
    d = torch.zeros((40, 4))
    for call in (lambda: tn.nnd(X, cfg, max_iter=1),
                 lambda: tn.nnd_init(None, X, cfg),
                 lambda: tn.nnd_step(torch.tensor([0, 1]), X, idx, d, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    idx, d, hist = tn.nnd(X, cfg, max_iter=2, device="cpu")
    assert idx.device.type == "cpu" and len(hist) == 2


def test_nnd_config_mirrors_jax_without_backend():
    j_fields = {f.name: f.default for f in dataclasses.fields(jn.NNDConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(tn.NNDConfig)}
    j_fields.pop("backend")
    assert t_fields == j_fields
