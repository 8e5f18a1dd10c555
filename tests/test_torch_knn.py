"""The port's counter RNG, list primitives, affinities and quality metric
against the JAX package, plus the port's import and device guards.

Inputs are made with numpy from a seed and fed to both packages.  Discrete
results (hash draws, ids, flags) must match exactly; coordinates are
quantised to quarter-integers where a result depends on distances, so every
squared distance is exact whatever the summation order.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import affinities as j_aff  # noqa: E402
from repro.core import knn as j_knn  # noqa: E402
from repro.core import quality as j_quality  # noqa: E402
from repro.kernels.knn_merge.kernel import merge_select as j_merge_select  # noqa: E402
from repro_torch.core import affinities as t_aff  # noqa: E402
from repro_torch.core import knn as t_knn  # noqa: E402
from repro_torch.core import quality as t_quality  # noqa: E402
from repro_torch.kernels.knn_merge.ref import merge_select as t_merge_select  # noqa: E402

torch.set_num_threads(1)
SENTINEL = int(j_knn.SENTINEL)
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _i32(rng, shape, lo=-2 ** 31, hi=2 ** 31):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


# --------------------------------------------------------------------------
# Counter RNG: bit-exact


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counter_draws_bit_exact(seed):
    rng = np.random.default_rng(seed)
    salt, row, draw = _i32(rng, 4096), _i32(rng, 4096), _i32(rng, 4096)
    h_j = np.asarray(j_knn.hash3(jnp.asarray(salt), jnp.asarray(row),
                                 jnp.asarray(draw)))
    h_t = t_knn.hash3(torch.from_numpy(salt), torch.from_numpy(row),
                      torch.from_numpy(draw))
    assert h_t.dtype == torch.int32
    np.testing.assert_array_equal(h_t.numpy(), h_j)
    np.testing.assert_array_equal(
        t_knn.hash_mix(torch.from_numpy(salt)).numpy(),
        np.asarray(j_knn.hash_mix(jnp.asarray(salt))))
    np.testing.assert_array_equal(
        t_knn.counter_uniform01(torch.from_numpy(h_j)).numpy(),
        np.asarray(j_knn.counter_uniform01(jnp.asarray(h_j))))
    for bound in (1, 7, 16, 70_000, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            t_knn.counter_randint(torch.from_numpy(salt),
                                  torch.from_numpy(row),
                                  torch.from_numpy(draw), bound).numpy(),
            np.asarray(j_knn.counter_randint(jnp.asarray(salt),
                                             jnp.asarray(row),
                                             jnp.asarray(draw), bound)))


@pytest.mark.parametrize("key", [0, 1, 42, 2 ** 31 - 1])
def test_key_salt_matches_jax(key):
    k = jax.random.PRNGKey(key)
    words = np.asarray(jax.random.key_data(k))
    assert words.dtype == np.uint32 and words.shape == (2,)
    got = t_knn.key_salt(torch.from_numpy(words.astype(np.int64)))
    assert int(got) == int(j_knn.key_salt(k))
    assert int(t_knn.as_salt(got)) == int(got)


@pytest.mark.parametrize("seed", [3, 4])
def test_counter_candidates_bit_exact(seed):
    """Every source kind, SENTINEL mids (-> row % n2), out-of-range extras."""
    rng = np.random.default_rng(seed)
    n, b = 97, 41
    rows = rng.integers(0, n, b).astype(np.int32)
    f0 = rng.integers(0, n, (b, 6)).astype(np.int32)
    f0[rng.random((b, 6)) < 0.2] = SENTINEL
    f1 = rng.integers(0, n, (b, 5)).astype(np.int32)
    s0 = rng.integers(0, n, (n, 6)).astype(np.int32)
    s0[rng.random((n, 6)) < 0.1] = SENTINEL
    s1 = rng.integers(0, 60, (60, 3)).astype(np.int32)
    extra = rng.integers(-3, n + 3, (b, 2)).astype(np.int32)
    sources = (("two_hop", 0, 0, 3), ("one_hop", 1, 2), ("uniform", 0),
               ("two_hop", 1, 1, 2), ("uniform", 3), ("extra", 2))
    salt = int(_i32(rng, ()))
    want = j_knn.counter_candidates(
        jnp.int32(salt), jnp.asarray(rows), sources,
        (jnp.asarray(f0), jnp.asarray(f1)), (jnp.asarray(s0), jnp.asarray(s1)),
        n_total=n, extra=jnp.asarray(extra))
    got = t_knn.counter_candidates(
        torch.tensor(salt, dtype=torch.int32), torch.from_numpy(rows),
        sources, (torch.from_numpy(f0), torch.from_numpy(f1)),
        (torch.from_numpy(s0), torch.from_numpy(s1)), n_total=n,
        extra=torch.from_numpy(extra))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_knn_idx_distinct_and_self_free():
    key = torch.tensor([0, 0])
    idx = t_knn.init_knn_idx(key, 300, 300, 32).numpy()
    assert idx.dtype == np.int32 and idx.shape == (300, 32)
    assert ((idx >= 0) & (idx < 300)).all()
    assert (idx != np.arange(300)[:, None]).all()
    assert all(len(set(r)) == 32 for r in idx)
    with pytest.raises(ValueError):
        t_knn.init_knn_idx(key, 10, 10, 10)


# --------------------------------------------------------------------------
# Dedup and merge: exact on quantised inputs, ties included


def _merge_problem(seed, n=60, m=5, b=48, k=8, c=7):
    """Duplicate-free current lists sorted by exact distance (SENTINEL
    tails), candidates with duplicates, SENTINEL and out-of-range ids."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-3, 4, (n, m)) / 4.0).astype(np.float32)  # many ties
    qid = rng.permutation(n)[:b].astype(np.int32)
    cur = np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(np.int32)
    d = ((x[cur] - x[qid][:, None]) ** 2).sum(-1).astype(np.float32)
    sent = np.sort(rng.random((b, k)) < 0.2, axis=1)
    cur[sent], d[sent] = SENTINEL, np.inf
    order = np.argsort(d, axis=1, kind="stable")
    cur, d = (np.take_along_axis(cur, order, 1),
              np.take_along_axis(d, order, 1))
    cand = rng.integers(-2, n + 2, (b, c)).astype(np.int32)
    cand[:, 1] = cand[:, 0]                        # an earlier duplicate
    cand[:, 2] = cur[:, 0]                         # already in the list
    cand[:, 3] = qid                               # the row itself
    cand[rng.random((b, c)) < 0.1] = SENTINEL
    cand_d = ((x[np.clip(cand, 0, n - 1)] - x[qid][:, None]) ** 2).sum(-1)
    ext = rng.random((b, c)) >= 0.15
    return qid, cur, d, cand, cand_d.astype(np.float32), ext


def _assert_list_invariants(idx, d):
    # comparisons, not np.diff: inf - inf would be NaN
    assert (d[:, 1:] >= d[:, :-1]).all()
    for row_i, row_d in zip(idx, d):
        fin = row_i[np.isfinite(row_d)]
        assert len(set(fin.tolist())) == len(fin)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dedup_merge_and_merge_select_exact(seed):
    qid, cur, d, cand, cand_d, ext = _merge_problem(seed)
    T = torch.from_numpy
    valid_j = np.asarray(j_knn.dedup_candidates(jnp.asarray(qid),
                                                jnp.asarray(cur),
                                                jnp.asarray(cand))) & ext
    valid_t = t_knn.dedup_candidates(T(qid), T(cur), T(cand)).numpy() & ext
    np.testing.assert_array_equal(valid_t, valid_j)

    want = j_knn.merge_knn(jnp.asarray(cur), jnp.asarray(d),
                           jnp.asarray(cand), jnp.asarray(cand_d),
                           jnp.asarray(valid_j))
    got = t_knn.merge_knn(T(cur), T(d), T(cand), T(cand_d), T(valid_t))
    sel_t = t_merge_select(T(qid)[:, None], T(cur), T(d), T(cand), T(cand_d),
                           T(ext))
    sel_j = j_merge_select(jnp.asarray(qid)[:, None], jnp.asarray(cur),
                           jnp.asarray(d), jnp.asarray(cand),
                           jnp.asarray(cand_d), jnp.asarray(ext))
    for res in (got, sel_t, sel_j):
        for r, w, name in zip(res, want, ("idx", "d", "improved")):
            np.testing.assert_array_equal(np.asarray(r), np.asarray(w),
                                          err_msg=name)
    _assert_list_invariants(got[0].numpy(), got[1].numpy())


# --------------------------------------------------------------------------
# Affinities


# beta tolerance: XLA's exp/log and torch's differ in the last bits, and
# where a row's entropy lands within that rounding of log(perplexity) the
# bisection takes the other branch on one side.  Rows that never meet such
# a split agree to float32 rounding (BETA_RTOL); a split at iteration i
# leaves the two betas within the bracket width 2^-i of each other, so at
# most BETA_SPLIT_FRAC of the rows may differ, and none by more than 2%.
BETA_RTOL = 1e-5
BETA_SPLIT_FRAC = 0.02


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_beta_and_p_rows_within_tolerance(seed):
    """Sorted KNN distance lists of clustered data, with invalid (+inf)
    tail slots as the merged lists carry them."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 6, (5, 16))[rng.integers(0, 5, 400)]
         + rng.normal(size=(400, 16))).astype(np.float32)
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    d2 = (np.sort(d2, axis=1)[:, :32]
          * 10 ** rng.uniform(-2, 2, (400, 1))).astype(np.float32)
    d2[:40, -2:] = np.inf          # invalid tail slots on a few rows
    beta0 = rng.uniform(0.01, 2.0, 400).astype(np.float32)
    for b0 in (None, beta0):
        bj = np.asarray(j_aff.solve_beta(
            jnp.asarray(d2), 20.0, beta0=None if b0 is None
            else jnp.asarray(b0), n_iter=24))
        bt = t_aff.solve_beta(torch.from_numpy(d2), 20.0,
                              beta0=None if b0 is None
                              else torch.from_numpy(b0), n_iter=24).numpy()
        rel = np.abs(bt - bj) / np.abs(bj)
        assert (rel > BETA_RTOL).mean() <= BETA_SPLIT_FRAC, rel.max()
        assert rel.max() < 0.02, rel.max()
    pj = np.asarray(j_aff.p_rows(jnp.asarray(d2), jnp.asarray(bj)))
    pt = t_aff.p_rows(torch.from_numpy(d2), torch.from_numpy(bj)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-7)
    hj = np.asarray(j_aff.entropy_of_beta(jnp.asarray(d2), jnp.asarray(bj),
                                          jnp.isfinite(jnp.asarray(d2))))
    ht = t_aff.entropy_of_beta(torch.from_numpy(d2), torch.from_numpy(bj),
                               torch.isfinite(torch.from_numpy(d2))).numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# Exact KNN and R_NX


def test_exact_knn_matches_jax_with_ties_and_rows():
    rng = np.random.default_rng(5)
    x = (rng.integers(-2, 3, (120, 4)) / 2.0).astype(np.float32)  # ties
    active = rng.random(120) >= 0.1
    ij, dj = j_knn.exact_knn(jnp.asarray(x), 10, jnp.asarray(active))
    it, dt = t_knn.exact_knn(torch.from_numpy(x), 10,
                             torch.from_numpy(active))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    rows = torch.tensor([5, 0, 77])
    ir, _ = t_knn.exact_knn(torch.from_numpy(x), 10, torch.from_numpy(active),
                            rows=rows)
    np.testing.assert_array_equal(ir.numpy(), np.asarray(ij)[[5, 0, 77]])


def test_embedding_quality_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    y = (x[:, :2] + 0.3 * rng.normal(size=(300, 2))).astype(np.float32)
    want = float(j_quality.embedding_quality(jnp.asarray(x), jnp.asarray(y),
                                             kmax=32))
    got = float(t_quality.embedding_quality(torch.from_numpy(x),
                                            torch.from_numpy(y), kmax=32))
    assert abs(got - want) < 1e-6, (got, want)
    tj, _ = j_knn.exact_knn(jnp.asarray(x), 16)
    ej, _ = j_knn.exact_knn(jnp.asarray(y), 16)
    np.testing.assert_allclose(
        t_quality.rnx_curve(torch.from_numpy(np.asarray(ej)),
                            torch.from_numpy(np.asarray(tj))).numpy(),
        np.asarray(j_quality.rnx_curve(ej, tj)), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# Guards: the port imports neither jax nor repro


def _port_modules():
    return sorted(
        "repro_torch." + ".".join(p.relative_to(SRC).with_suffix("").parts)
        .replace(".__init__", "").rstrip(".")
        for p in SRC.rglob("*.py")) + ["repro_torch"]


def test_port_imports_without_jax_or_repro():
    """Every module imports in a fresh process where ``jax`` and ``repro``
    are poisoned, and no source line imports them."""
    mods = [m for m in _port_modules() if m != "repro_torch.__init__"]
    code = ("import sys\n"
            "for name in ('jax', 'jax.numpy', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC.parent))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                     re.M)
    files = list(SRC.rglob("*.py")) + [SRC.parents[1] / "chip_smoke.py"]
    hits = [str(p) for p in files if bad.search(p.read_text())]
    assert not hits, hits


def test_port_guard_covers_resilience_modules():
    """The guard above imports the resilience slice's modules (the
    checkpoint and runtime subpackages, the policy, the fallback registry
    and the session example) in its poisoned process, and no script under
    ``scripts/`` imports jax or repro either."""
    mods = set(_port_modules())
    assert {"repro_torch.checkpoint", "repro_torch.checkpoint.checkpointer",
            "repro_torch.checkpoint.verify", "repro_torch.runtime",
            "repro_torch.runtime.faults", "repro_torch.runtime.straggler",
            "repro_torch.core.resilience", "repro_torch.kernels.fallback",
            "repro_torch.examples.dynamic_stream"} <= mods
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                     re.M)
    scripts = list((SRC.parents[1] / "scripts").glob("*.py"))
    assert scripts
    assert not [str(p) for p in scripts if bad.search(p.read_text())]
