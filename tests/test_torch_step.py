"""The port's step, chunk runner and fit against the JAX package.

Both packages start from one JAX-made state passed through the numpy
bridge (``repro_torch.core.convert``), so the float fields start equal
(``init_state``'s own start is held to JAX in
``tests/test_torch_threefry.py``).  X is quantised to quarter-integers, so
HD distances are exact and the discrete fields must match exactly; the
float fields carry the rounding of two compilers (XLA may contract a*b+c
into one FMA, torch does not; exp/log differ in the last bits):

  Y, vel:  |port - jax| <= F_RTOL * max|jax| + F_ATOL
  gains:   equal on all but GAINS_FRAC of entries (a sign comparison of a
           near-zero force can flip, moving one entry by a factor 0.8/+0.2)
  beta:    BETA_RTOL on every row (see tests/test_torch_knn.py for why
           bisection may split; it does not on these inputs)
  zhat, ema_new_frac: relative 1e-5
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import funcsne as jf  # noqa: E402
from repro.core import knn as j_knn  # noqa: E402
from repro.core.quality import embedding_quality as j_quality  # noqa: E402
from repro.data.synthetic import blobs  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core.quality import embedding_quality as t_quality  # noqa: E402
from repro_torch.launch import embed as t_embed  # noqa: E402

torch.set_num_threads(1)
F_RTOL, F_ATOL = 1e-4, 1e-6
GAINS_FRAC = 0.01
BETA_RTOL = 1e-5
# |AUC_port - AUC_jax| after 200 steps from one state: the float drift of
# the two compilers grows over the run into a different (equally good)
# layout, so the runs are compared by quality, not coordinates
AUC_BAND = 0.03


def _fields(st):
    out = {k: np.asarray(v) for k, v in st._asdict().items() if k != "rng"}
    out["rng"] = np.asarray(jax.random.key_data(st.rng))
    return out


def _problem(n=160, m=12, seed=0, **flags):
    """Quantised blobs and one JAX-made state bridged to the port; ``flags``
    are config fields that both packages share."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (4, m))
    x = centers[rng.integers(0, 4, n)] + rng.integers(-3, 4, (n, m))
    X = (x / 4.0).astype(np.float32)
    jcfg = jf.FuncSNEConfig(n_points=n, dim_hd=m, backend="xla", **flags)
    tcfg = tf.FuncSNEConfig(n_points=n, dim_hd=m, **flags)
    jhp = jf.default_hparams(n, perplexity=20.0)
    jst = jf.init_state(jax.random.PRNGKey(seed + 3), jnp.asarray(X), jcfg,
                        perplexity=jhp.perplexity)
    thp = tf.default_hparams(n, perplexity=20.0, device="cpu")
    tst = convert.state_from_numpy(_fields(jst), tcfg, "cpu")
    return X, jcfg, tcfg, jhp, thp, jst, tst


def _assert_states_match(jst, tst):
    a, b = _fields(jst), convert.state_to_numpy(tst)
    for name in ("hd_idx", "ld_idx", "new_flag", "active", "step", "rng",
                 "hd_d", "rev_idx", "rev_step"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    for name in ("Y", "vel", "ld_d"):
        np.testing.assert_allclose(
            b[name], a[name], rtol=0,
            atol=F_RTOL * np.abs(a[name][np.isfinite(a[name])]).max() + F_ATOL,
            err_msg=name)
    assert (b["gains"] != a["gains"]).mean() <= GAINS_FRAC
    np.testing.assert_allclose(b["beta"], a["beta"], rtol=BETA_RTOL)
    for name in ("zhat", "ema_new_frac"):
        np.testing.assert_allclose(b[name], a[name], rtol=1e-5, err_msg=name)


def _gate(rng_words, step, ema):
    """The refinement gate of a state, as both packages compute it."""
    u = j_knn.counter_uniform01(j_knn.hash3(
        j_knn.key_salt(jnp.asarray(rng_words)), jnp.int32(step), 1))
    return bool(u < jnp.clip(0.05 + 0.95 * jnp.float32(ema), 0.0, 1.0))


def test_one_step_matches_jax():
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem()
    jst1 = jax.jit(lambda s, x, h: jf.funcsne_step(jcfg, s, x, h))(
        jst, jnp.asarray(X), jhp)
    tst1 = tf.funcsne_step(tcfg, tst, torch.from_numpy(X), thp)
    _assert_states_match(jst1, tst1)
    assert int(tst1.step) == 1
    # the HD refinement ran (step 0's gate always fires) and merged
    assert (np.asarray(jst1.hd_idx) != np.asarray(jst.hd_idx)).any()


def test_chunk_of_ten_matches_jax_and_gates_agree():
    """One T=10 chunk with default_schedule against the JAX chunk; the
    per-step gate decisions of both packages' step-by-step runs agree."""
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(seed=1)
    # a low E[N_new/N] so that the gate both fires and skips
    jst = jst._replace(ema_new_frac=jnp.float32(0.3))
    tst = tst._replace(ema_new_frac=torch.tensor(0.3))
    T = 10
    jchunk = jf.make_chunked_step(jcfg, T, schedule=jf.default_schedule,
                                  n_iter=T)
    jst_c, _, jm = jchunk(jax.tree.map(jnp.array, jst), jnp.asarray(X), jhp)
    tchunk = tf.make_chunked_step(tcfg, T, schedule=tf.default_schedule,
                                  n_iter=T)
    tst_c, _, tm = tchunk(tst, torch.from_numpy(X), thp)
    _assert_states_match(jst_c, tst_c)
    assert int(tm.step) == int(jm.step) == T
    assert int(tm.bad_step) == int(jm.bad_step) == -1
    np.testing.assert_allclose(float(tm.disp_ema), float(jm.disp_ema),
                               rtol=1e-3)

    # gates: the port's step-by-step states vs the JAX chunk's inputs
    # replayed one step at a time (the JAX schedule is exact on the host)
    jstep = jax.jit(lambda s, x, h: jf.funcsne_step(jcfg, s, x, h))
    gates_j, gates_t = [], []
    js, ts = jst, tst
    for it in range(T):
        f = _fields(js)
        gates_j.append(_gate(f["rng"], it, f["ema_new_frac"]))
        gates_t.append(_gate(convert.state_to_numpy(ts)["rng"], it,
                             float(ts.ema_new_frac)))
        js = jstep(js, jnp.asarray(X), jf.default_schedule(it, T, jhp))
        ts = tf.funcsne_step(tcfg, ts, torch.from_numpy(X),
                             tf.default_schedule(it, T, thp))
    assert gates_t == gates_j
    assert any(gates_j) and not all(gates_j)


def test_default_schedule_matches_jax():
    jhp = jf.default_hparams(1000)
    thp = tf.default_hparams(1000, device="cpu")
    for it in (0, 1, 49, 50, 51, 150, 199):
        a, b = jf.default_schedule(it, 200, jhp), tf.default_schedule(
            it, 200, thp)
        for name in jf.HParams._fields:
            assert float(getattr(a, name)) == float(getattr(b, name)), name


def test_fit_200_steps_auc_within_band_of_jax():
    """200 steps of blobs (n = 1,000) from one state: the R_NX AUCs of the
    two embeddings agree within AUC_BAND."""
    X, _ = blobs(n=1000, dim=16, n_centers=6, center_std=6.0, seed=2)
    n = X.shape[0]
    jcfg = jf.FuncSNEConfig(n_points=n, dim_hd=16, backend="xla")
    tcfg = tf.FuncSNEConfig(n_points=n, dim_hd=16)
    jhp = jf.default_hparams(n)
    jst0 = jf.init_state(jax.random.PRNGKey(0), jnp.asarray(X), jcfg)
    tst0 = convert.state_from_numpy(_fields(jst0), tcfg, "cpu")
    jst, _ = jf.fit(jnp.asarray(X), cfg=jcfg, n_iter=200, hparams=jhp,
                    state=jst0, chunk_size=50)
    tst, _ = tf.fit(X, cfg=tcfg, n_iter=200, state=tst0, chunk_size=50,
                    device="cpu")
    q_j = float(j_quality(jnp.asarray(X), jst.Y))
    q_t = float(t_quality(torch.from_numpy(X), tst.Y))
    assert q_j > 0.1, q_j              # an embedding, not noise (~0)
    assert abs(q_t - q_j) <= AUC_BAND, (q_t, q_j)


# --------------------------------------------------------------------------
# Entry points: the card unless the caller asks for the CPU; what is not
# ported raises


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, _ = blobs(n=64, dim=4, seed=0)
    cfg = tf.FuncSNEConfig(n_points=64, dim_hd=4, k_hd=8, k_ld=4)
    for call in (lambda: tf.fit(X, cfg=cfg, n_iter=1),
                 lambda: tf.init_state(X, cfg),
                 lambda: tf.default_hparams(64),
                 lambda: t_embed.main(["--n", "64", "--iters", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    st, _ = tf.fit(X, cfg=cfg, n_iter=2, device="cpu")
    assert st.Y.device.type == "cpu" and int(st.step) == 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.state_from_numpy(convert.state_to_numpy(st), cfg, "cuda")


def test_unported_options_raise():
    """What is still unported raises: the fit/CLI options; every flag
    setting of the config, ``cand_fused=False`` included, constructs."""
    for kw in (dict(gather_fused=False), dict(scatter_fused=False),
               dict(merge_fused=False), dict(c_hd_rev=2, rev_refresh=1),
               dict(cand_fused=False), dict(c_hd_rev=2, cand_fused=False)):
        cfg = tf.FuncSNEConfig(n_points=10, dim_hd=3, **kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
    X = np.zeros((20, 3), np.float32)
    for kw in (dict(callback=print), dict(early_stop=0.1), dict(auto_rescale=0.1),
               dict(resilience=object()), dict(resume_from="ckpt")):
        with pytest.raises(NotImplementedError):
            tf.fit(X, device="cpu", **kw)
    for argv in (["--devices", "2"], ["--num-processes", "2"],
                 ["--checkpoint-dir", "ckpt"], ["--audit-every", "3"]):
        with pytest.raises(NotImplementedError):
            t_embed.main(argv + ["--device", "cpu"])


def test_state_bridge_round_trip_and_checks():
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(n=40)
    back = convert.state_to_numpy(tst)
    a = _fields(jst)
    for name in back:
        np.testing.assert_array_equal(back[name], a[name], err_msg=name)
        assert back[name].dtype == a[name].dtype, name
    # a reverse cache must have the config's width (c_hd_rev = 0 here)
    with pytest.raises(ValueError, match="rev_idx"):
        convert.state_from_numpy(dict(a, rev_idx=np.zeros((40, 2), np.int32)),
                                 tcfg, "cpu")
    with pytest.raises(ValueError):
        convert.state_from_numpy(a, dataclasses.replace(tcfg, k_ld=8), "cpu")
