"""The port's exact oracle, LD kernels and negative-sampling baseline
against the JAX package's.

Inputs are made from a seed with numpy; X is quantised to quarter-integers
so that the exact KNN lists and their distances are exact in both
packages (ties broken by the lower index in both).  Float results carry
the rounding of two compilers (XLA may contract a*b+c into one FMA, exp
and log1p differ in the last bits), so they are held within:

  LD kernels, P, gradients:  relative F32_RTOL of each array's largest
                             entry (a handful of float32 ulps)
  Y after a few iterations:  relative Y_RTOL of max|Y|
  NS quality over 300 its:   |AUC_port - AUC_jax| <= AUC_BAND (the runs
                             part in the last bits, then chaotically)
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.core import funcsne as jf  # noqa: E402
from repro.core import ld_kernels as jl  # noqa: E402
from repro.core import quality as jq  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core import ld_kernels as tl  # noqa: E402
from repro_torch.core import quality as tq  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402

torch.set_num_threads(1)
F32_RTOL = 2e-6
Y_RTOL = 1e-4
AUC_BAND = 0.03


def _quantised(n, m, seed, n_centers=4, spread=3):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (n_centers, m))
    x = centers[rng.integers(0, n_centers, n)] \
        + rng.integers(-spread, spread + 1, (n, m))
    return (x / 4.0).astype(np.float32)


def _close(got, want, rtol=F32_RTOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max() + 1e-30,
                               err_msg=name)


# --------------------------------------------------------------------------
# ld_kernels


@pytest.mark.parametrize("alpha", [0.5, 1.0, 3.0])
def test_ld_kernels_match_jax(alpha):
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(40, 3)).astype(np.float32)
    d2 = (rng.random((40, 40)) * 10.0).astype(np.float32)
    a_t = torch.tensor(alpha, dtype=torch.float32)
    for jfn, tfn in ((jl.w_tail, tl.w_tail),
                     (jl.w_pow_inv_alpha, tl.w_pow_inv_alpha),
                     (jl.w_pow_one_plus_inv_alpha,
                      tl.w_pow_one_plus_inv_alpha)):
        _close(tfn(torch.from_numpy(d2), a_t), jfn(jnp.asarray(d2), alpha),
               name=jfn.__name__)
    Yq = np.round(Y * 4.0) / 4.0
    # quarter-grid rows: the dense distances are exact in both packages
    np.testing.assert_array_equal(
        tl.pairwise_sqdists_full(torch.from_numpy(Yq)).numpy(),
        np.asarray(jl.pairwise_sqdists_full(jnp.asarray(Yq))))
    q_t, w_t = tl.q_matrix(torch.from_numpy(Y), a_t)
    q_j, w_j = jl.q_matrix(jnp.asarray(Y), alpha)
    _close(q_t, q_j, 1e-5, "q")
    _close(w_t, w_j, 1e-5, "w")
    assert float(q_t.diagonal().abs().max()) == 0.0
    P = np.array(jb.exact_p_matrix(jnp.asarray(_quantised(40, 5, 1)), 8.0))
    kl_t = float(tl.kl_loss(torch.from_numpy(P), torch.from_numpy(Y), a_t))
    kl_j = float(jl.kl_loss(jnp.asarray(P), jnp.asarray(Y), alpha))
    assert abs(kl_t - kl_j) <= 1e-5 * abs(kl_j), (kl_t, kl_j)


def test_exact_p_matrix_matches_jax():
    X = _quantised(120, 6, 2)
    for perp in (5.0, 30.0):
        p_t = tb.exact_p_matrix(torch.from_numpy(X), perp)
        p_j = jb.exact_p_matrix(jnp.asarray(X), perp)
        _close(p_t, p_j, 1e-5, f"P perplexity {perp}")
        np.testing.assert_allclose(float(p_t.sum()), 1.0, rtol=1e-5)
        np.testing.assert_allclose(p_t.numpy(), p_t.numpy().T, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 2.0])
def test_exact_tsne_grad_and_autograd_match_jax(alpha):
    X = _quantised(90, 5, 3)
    P = np.array(jb.exact_p_matrix(jnp.asarray(X), 20.0))
    Y = np.random.default_rng(4).normal(size=(90, 2)).astype(np.float32)
    Pt, Yt = torch.from_numpy(P), torch.from_numpy(Y)
    a_t = torch.tensor(alpha, dtype=torch.float32)
    g_t = tb.exact_tsne_grad(Yt, Pt, a_t)
    g_j = jb.exact_tsne_grad(jnp.asarray(Y), jnp.asarray(P), alpha)
    _close(g_t, g_j, 1e-5, "analytic gradient")
    # torch.autograd of kl_loss against jax.grad of the JAX kl_loss
    y = Yt.clone().requires_grad_(True)
    a_grad = torch.autograd.grad(tl.kl_loss(Pt, y, a_t), y)[0]
    j_grad = jax.grad(lambda v: jl.kl_loss(jnp.asarray(P), v, alpha))(
        jnp.asarray(Y))
    _close(a_grad, j_grad, 1e-5, "autograd")
    # and both are the analytic gradient (Eq. 5)
    _close(a_grad, g_t, 1e-4, "autograd vs analytic")


@pytest.mark.parametrize("use_autodiff", [False, True])
def test_exact_tsne_five_iterations_match_jax(use_autodiff):
    """Both branches from one Y0 over 5 iterations (exaggeration 12 on the
    first); the autodiff branch drops the exaggeration, as in JAX."""
    X = _quantised(80, 6, 5)
    Y0 = np.random.default_rng(6).normal(size=(80, 2)).astype(np.float32)
    kw = dict(perplexity=15.0, n_iter=5, use_autodiff=use_autodiff)
    y_t = tb.exact_tsne(X, Y0=Y0, device="cpu", **kw).numpy()
    y_j = np.asarray(jb.exact_tsne(jnp.asarray(X), Y0=jnp.asarray(Y0), **kw))
    _close(y_t, y_j, Y_RTOL, "Y")
    other = tb.exact_tsne(X, Y0=Y0, device="cpu",
                          **dict(kw, use_autodiff=not use_autodiff)).numpy()
    # the branches part: the exaggeration of the first iteration
    assert np.abs(other - y_t).max() > 100 * Y_RTOL * np.abs(y_t).max()


def test_exact_tsne_seeded_start_matches_jax():
    """Without Y0 the start is threefry's normal(PRNGKey(seed)) * 1e-2."""
    X = _quantised(60, 4, 7)
    y_t = tb.exact_tsne(X, perplexity=10.0, n_iter=3, seed=3,
                        device="cpu").numpy()
    y_j = np.asarray(jb.exact_tsne(jnp.asarray(X), perplexity=10.0, n_iter=3,
                                   rng=jax.random.PRNGKey(3)))
    _close(y_t, y_j, Y_RTOL, "Y")
    assert np.isfinite(y_t).all()


def test_exact_tsne_lowers_kl():
    X = _quantised(100, 6, 8)
    P = tb.exact_p_matrix(torch.from_numpy(X), 20.0)
    a = torch.tensor(1.0)
    Y0 = threefry.normal(threefry.prng_key(0), (100, 2)) * 1e-2
    Y = tb.exact_tsne(P=P, Y0=Y0, n_iter=100, device="cpu")
    assert float(tl.kl_loss(P, Y, a)) < 0.5 * float(tl.kl_loss(P, Y0, a))


# --------------------------------------------------------------------------
# Negative sampling


def _ns_jax_negatives(seed, it, n, n_neg):
    _, r_it = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(jax.random.randint(jax.random.fold_in(r_it, it),
                                         (n, n_neg), 0, n))


def test_ns_negatives_and_phase_one_match_jax():
    X = _quantised(200, 8, 9)
    n = X.shape[0]
    cfg = tb.NSConfig()
    thp = tf.default_hparams(n, device="cpu")
    prob, st = tb.ns_init(torch.from_numpy(X), cfg, dim_ld=2, hparams=thp,
                          seed=4)
    for it in (0, 1, 2, 7, 749):
        np.testing.assert_array_equal(
            tb.ns_negatives(prob, it, cfg.n_negatives).numpy(),
            _ns_jax_negatives(4, it, n, cfg.n_negatives), err_msg=f"it {it}")
    from repro.core import affinities as ja
    from repro.core import knn as jk
    idx, d2 = jk.exact_knn(jnp.asarray(X), cfg.k_hd)
    np.testing.assert_array_equal(prob.idx.numpy(), np.asarray(idx))
    p = ja.p_rows(d2, ja.solve_beta(d2, jf.default_hparams(n).perplexity))
    _close(prob.p, p, 1e-5, "p")
    r_y, _ = jax.random.split(jax.random.PRNGKey(4))
    _close(st.Y, jax.random.normal(r_y, (n, 2)) * 1e-2, 1e-6, "Y0")
    assert float(st.zhat) == float(n)


@pytest.mark.parametrize("dim_ld", [2, 3])
def test_ns_five_iterations_match_jax(dim_ld):
    X = _quantised(150, 8, 10)
    kw = dict(dim_ld=dim_ld, n_iter=5)
    reset_launches()
    y_t = tb.negative_sampling_embed(X, seed=2, device="cpu", **kw).numpy()
    assert not any(LAUNCHES.values())      # the CPU runs the plain versions
    y_j = np.asarray(jb.negative_sampling_embed(
        jnp.asarray(X), cfg=jb.NSConfig(backend="xla"),
        rng=jax.random.PRNGKey(2), **kw))
    _close(y_t, y_j, Y_RTOL, "Y")


def test_ns_step_ops_kernels_and_plain_agree_on_cpu():
    """``ns_step`` through KERNELS (plain on CPU tensors) and PLAIN is one
    computation here; on the card the same call holds the kernels."""
    X = _quantised(100, 6, 11)
    cfg = tb.NSConfig(k_hd=16, n_negatives=4)
    thp = tf.default_hparams(100, device="cpu")
    prob, st = tb.ns_init(torch.from_numpy(X), cfg, dim_ld=2, hparams=thp,
                          seed=0)
    neg = tb.ns_negatives(prob, 0, cfg.n_negatives)
    hp = tf.default_schedule(0, 10, thp)
    a = tb.ns_step(cfg, prob, st, neg, hp, 0, ops=tf.KERNELS)
    b = tb.ns_step(cfg, prob, st, neg, hp, 0, ops=tf.PLAIN)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_ns_300_iterations_quality_within_band_of_jax():
    """n = 500 over 300 iterations: the R_NX AUCs of the two embeddings
    agree within AUC_BAND, and both embed (AUC well above chance, 0)."""
    X = _quantised(500, 10, 12, n_centers=6, spread=4)
    y_t = tb.negative_sampling_embed(X, n_iter=300, device="cpu")
    y_j = jb.negative_sampling_embed(jnp.asarray(X), n_iter=300,
                                     cfg=jb.NSConfig(backend="xla"))
    q_t = float(tq.embedding_quality(torch.from_numpy(X), y_t))
    q_j = float(jq.embedding_quality(jnp.asarray(X), y_j))
    assert q_j > 0.1, q_j
    assert abs(q_t - q_j) <= AUC_BAND, (q_t, q_j)
    assert torch.isfinite(y_t).all()


# --------------------------------------------------------------------------
# quality.embedding_rnx_curve


@pytest.mark.parametrize("kmax", [8, 64, 500])
def test_embedding_rnx_curve_exact(kmax):
    X = _quantised(150, 6, 13)
    Y = np.round(np.random.default_rng(14).normal(size=(150, 2)) * 8.0) / 4.0
    Y = Y.astype(np.float32)
    got = tq.embedding_rnx_curve(torch.from_numpy(X), torch.from_numpy(Y),
                                 kmax=kmax).numpy()
    want = np.asarray(jq.embedding_rnx_curve(jnp.asarray(X), jnp.asarray(Y),
                                             kmax=kmax))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_no_torch_generator_draw():
    """Every draw of these paths comes from threefry: the default torch
    generator's state is untouched."""
    X = _quantised(80, 5, 15)
    before = torch.random.get_rng_state()
    tb.negative_sampling_embed(X, n_iter=3, device="cpu")
    tb.exact_tsne(X, n_iter=3, perplexity=10.0, device="cpu")
    tb.exact_tsne(X, n_iter=2, perplexity=10.0, use_autodiff=True,
                  device="cpu")
    cfg = tf.FuncSNEConfig(n_points=80, dim_hd=5, k_hd=8, k_ld=4)
    st = tf.init_state(X, cfg, device="cpu")
    st = tf.add_points(tf.remove_points(st, torch.arange(10)),
                       torch.arange(5), threefry.prng_key(1))
    tf.fit(X, cfg=cfg, n_iter=3, state=st, early_stop=1e-30,
           auto_rescale=1e-30, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), before)
