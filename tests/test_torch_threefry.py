"""The port's threefry (``repro_torch.core.threefry``), its samplers and the
``init_state`` start against ``jax.random`` and the JAX package.

  * ``split``, ``fold_in``, 32-bit ``bits``, ``uniform``, ``bernoulli`` and
    ``randint`` bit for bit, for ``PRNGKey`` keys and split-derived keys,
    including ``randint`` spans above 2^16, where JAX's uint32 arithmetic
    wraps (the multiplier becomes 0);
  * ``normal`` within NORMAL_ULPS float32 ulps (XLA's ``erf_inv`` polynomial
    is ported term for term; its ``log1p`` and fused multiply-adds round
    differently);
  * the threefry samplers of ``core.knn`` and ``reverse_neighbors(fill_rng=)``
    exact;
  * ``init_state(X, cfg, seed=s)`` against the JAX
    ``init_state(PRNGKey(s), X, cfg)``: lists, flags and key exact on
    quantised X, Y within Y_RTOL of its largest entry, ``beta`` within the
    BETA_RTOL of ``tests/test_torch_step.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import funcsne as jf  # noqa: E402
from repro.core import knn as j_knn  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core import knn as t_knn  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from test_torch_step import BETA_RTOL, _fields, _problem  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
J = jnp.asarray
SENTINEL = int(j_knn.SENTINEL)
NORMAL_ULPS = 4
# Y of init_state: the PCA probe or random start comes from normal(), so Y
# carries its few-ulp error (through a QR power iteration for "pca")
Y_RTOL = 1e-5

KEYS = {
    "seed0": lambda: jax.random.PRNGKey(0),
    "seed42": lambda: jax.random.PRNGKey(42),
    "seed_neg": lambda: jax.random.PRNGKey(-5),
    "seed_max": lambda: jax.random.PRNGKey(2 ** 31 - 1),
    "split": lambda: jax.random.split(jax.random.PRNGKey(7), 3)[2],
    "fold": lambda: jax.random.fold_in(jax.random.PRNGKey(1), 12345),
}


def _tk(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, -1])
def test_prng_key_matches_jax(seed):
    _eq(threefry.prng_key(seed).numpy(), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("name", list(KEYS))
@pytest.mark.parametrize("num", [2, 3, 4, 5])
def test_split_exact(name, num):
    key = KEYS[name]()
    got = threefry.split(_tk(key), num)
    assert got.shape == (num, 2)
    _eq(got.numpy(), jax.random.split(key, num))


@pytest.mark.parametrize("name", list(KEYS))
@pytest.mark.parametrize("data", [0, 1, 2 ** 31 - 1])
def test_fold_in_exact(name, data):
    key = KEYS[name]()
    want = jax.random.fold_in(key, data)
    _eq(threefry.fold_in(_tk(key), data).numpy(), want)
    # a tensor datum takes the device path of the function
    _eq(threefry.fold_in(_tk(key), torch.tensor(data)).numpy(), want)


@pytest.mark.parametrize("name", list(KEYS))
@pytest.mark.parametrize("shape", [(), (7,), (300, 5)])
def test_bits_and_uniform_exact(name, shape):
    key = KEYS[name]()
    _eq(threefry.random_bits(_tk(key), shape).numpy(),
        jax.random.bits(key, shape))
    u = threefry.uniform(_tk(key), shape)
    assert u.dtype == torch.float32 and tuple(u.shape) == shape
    _eq(u.numpy().view(np.int32),
        np.asarray(jax.random.uniform(key, shape)).view(np.int32))


@pytest.mark.parametrize("name", list(KEYS))
@pytest.mark.parametrize("p", [0.0, 0.05, 0.5, 1.0])
def test_bernoulli_exact(name, p):
    key = KEYS[name]()
    want = jax.random.bernoulli(key, jnp.full((64,), p, jnp.float32))
    got = threefry.bernoulli(_tk(key), torch.full((64,), p))
    assert got.dtype == torch.bool
    _eq(got.numpy(), want)
    # a 0-dim p, as the refinement gate draws it
    _eq(threefry.bernoulli(_tk(key), torch.tensor(p)).numpy(),
        jax.random.bernoulli(key, jnp.float32(p)))


@pytest.mark.parametrize("name", list(KEYS))
@pytest.mark.parametrize("bounds", [(0, 1), (0, 8), (0, 32), (0, 65536),
                                    (0, 65537), (0, 70000), (0, 2 ** 31 - 1),
                                    (-10, 10), (5, 3), (7, 7)])
def test_randint_exact(name, bounds):
    """Spans above 2^16 show JAX's uint32 wraps; maxval <= minval gives
    minval."""
    key = KEYS[name]()
    lo, hi = bounds
    want = np.asarray(jax.random.randint(key, (40, 5), lo, hi,
                                         dtype=jnp.int32))
    got = threefry.randint(_tk(key), (40, 5), lo, hi)
    assert got.dtype == torch.int32
    _eq(got.numpy(), want)
    if hi <= lo:
        assert (want == lo).all()


def test_randint_wrap_is_what_makes_it_exact():
    """At span 70,000 the unwrapped formula (hi * 2^32 + lo) mod span draws
    differently: the test above would catch arithmetic without the wrap."""
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    hi = np.asarray(jax.random.bits(k1, (200,))).astype(np.uint64)
    lo = np.asarray(jax.random.bits(k2, (200,))).astype(np.uint64)
    span = np.uint64(70000)
    unwrapped = ((hi % span) * np.uint64(2 ** 32 % 70000) + lo % span) % span
    want = np.asarray(jax.random.randint(key, (200,), 0, 70000))
    assert (unwrapped != want).any()
    _eq(threefry.randint(_tk(key), (200,), 0, 70000).numpy(), want)


@pytest.mark.parametrize("name", list(KEYS))
def test_normal_within_ulps(name):
    key = KEYS[name]()
    want = np.asarray(jax.random.normal(key, (500, 7)))
    got = threefry.normal(_tk(key), (500, 7)).numpy()
    assert got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= NORMAL_ULPS, ulps.max()
    assert (ulps == 0).mean() > 0.9          # mostly bit-identical


def test_key_validation():
    with pytest.raises(ValueError):
        threefry.prng_key(2 ** 31)
    with pytest.raises(ValueError):
        threefry.split(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        threefry.randint(threefry.prng_key(0), (2,), 0, 2 ** 31)


# --------------------------------------------------------------------------
# The threefry samplers


def _tables(seed, n=120, k=8):
    rng = np.random.default_rng(seed)
    first = rng.integers(0, n, (n, k)).astype(np.int32)
    first[rng.random((n, k)) < 0.1] = SENTINEL
    second = rng.integers(0, n, (n, k + 3)).astype(np.int32)
    return first, second


@pytest.mark.parametrize("seed", [0, 1])
def test_samplers_exact(seed):
    first, second = _tables(seed)
    n = first.shape[0]
    rows = np.arange(n, dtype=np.int32)
    key = jax.random.PRNGKey(seed + 10)
    _eq(t_knn.sample_hops(_tk(key), T(first), T(second), T(rows), 6).numpy(),
        j_knn.sample_hops(key, J(first), J(second), J(rows), 6))
    _eq(t_knn.sample_direct(_tk(key), T(first), 5).numpy(),
        j_knn.sample_direct(key, J(first), 5))
    _eq(t_knn.sample_uniform(_tk(key), n, 1000, 4).numpy(),
        j_knn.sample_uniform(key, n, 1000, 4))


def test_sample_hops_sentinel_mid_becomes_row():
    """A SENTINEL mid hops through row ``rows % N`` of the second table."""
    n, k = 50, 4
    first = np.full((n, k), SENTINEL, np.int32)
    second = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    rows = (np.arange(n, dtype=np.int32) + 7)       # rows % n wraps
    key = jax.random.PRNGKey(4)
    got = t_knn.sample_hops(_tk(key), T(first), T(second), T(rows), 3).numpy()
    _eq(got, j_knn.sample_hops(key, J(first), J(second), J(rows), 3))
    assert ((got // 3) == (rows % n)[:, None]).all()


@pytest.mark.parametrize("k", [1, 16, 32])
def test_init_knn_idx_exact(k):
    key = jax.random.PRNGKey(k)
    want = np.asarray(j_knn.init_knn_idx(key, 90, 300, k, row_offset=5))
    got = t_knn.init_knn_idx(_tk(key), 90, 300, k, row_offset=5)
    assert got.dtype == torch.int32
    _eq(got.numpy(), want)


@pytest.mark.parametrize("r", [1, 4])
def test_reverse_neighbors_fill_rng_exact(r):
    first, _ = _tables(r, n=80, k=6)
    key = jax.random.PRNGKey(20 + r)
    want = j_knn.reverse_neighbors(J(first), 80, r, fill_rng=key)
    got = t_knn.reverse_neighbors(T(first), 80, r, fill_rng=_tk(key))
    _eq(got.numpy(), want)
    with pytest.raises(ValueError, match="xor"):
        t_knn.reverse_neighbors(T(first), 80, r)
    with pytest.raises(ValueError, match="xor"):
        t_knn.reverse_neighbors(T(first), 80, r, fill_rng=_tk(key),
                                fill=got)


# --------------------------------------------------------------------------
# init_state draws as the JAX package draws


@pytest.mark.parametrize("init", ["pca", "random"])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_state_matches_jax(init, seed):
    X, jcfg, tcfg, _, _, _, _ = _problem(n=120)
    jst = jf.init_state(jax.random.PRNGKey(seed), J(X), jcfg, init=init,
                        perplexity=20.0)
    tst = tf.init_state(X, tcfg, seed=seed, init=init, perplexity=20.0,
                        device="cpu")
    a, b = _fields(jst), convert.state_to_numpy(tst)
    for name in ("hd_idx", "ld_idx", "rng", "hd_d", "new_flag", "active",
                 "step", "rev_idx", "rev_step", "ema_new_frac", "zhat"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    for name in ("Y", "ld_d"):
        np.testing.assert_allclose(b[name], a[name], rtol=0,
                                   atol=Y_RTOL * np.abs(a[name]).max(),
                                   err_msg=name)
    np.testing.assert_allclose(b["beta"], a["beta"], rtol=BETA_RTOL)
