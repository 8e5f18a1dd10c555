"""B8 (causal GQA flash attention) and the port's ``flash_chunked`` against
the JAX package on the CPU.

On CPU tensors the port runs its plain versions: ``flash_attention_ref``
(the materialised softmax, B8's plain version) and ``flash_chunked_ref``
(the online softmax over KV chunks of ``repro.models.attention``).  Both
are held to ``repro.kernels.flash_attention.ref.flash_attention_ref`` over
the sweep of ``tests/test_kernels.py`` (shapes x {none, softcap, window,
both}) at rtol = atol = 2e-5 in float32 (a different summation order of
the same float32 arithmetic), to ``flash_attention_pallas`` in interpret
mode on a few cases, and in bfloat16 at 5e-2 (outputs rounded to bf16 in
both, as in ``tests/test_kernels.py``).  The CUDA kernel itself is held
to the plain version on the card by ``chip_smoke.py`` (phase h).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref  # noqa: E402
from repro.models.attention import flash_chunked as j_chunked  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

torch.set_num_threads(1)
RTOL = ATOL = 2e-5
BF16_TOL = 5e-2
SHAPES = [(64, 32, 4, 2), (96, 64, 8, 8), (128, 32, 6, 1)]
OPTS = [{}, {"softcap": 10.0}, {"window": 23}, {"softcap": 5.0, "window": 17}]


def _qkv(s, d, hq, hkv, seed, b=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, hq, s, d)) * 0.4).astype(dtype)
    k = (rng.normal(size=(b, hkv, s, d)) * 0.4).astype(dtype)
    v = rng.normal(size=(b, hkv, s, d)).astype(dtype)
    return q, k, v


def _chunked(q, k, v, *, chunk_k=32, **opts):
    """The port's flash_chunked on (B, H, S, D) arrays, through its
    (B, S, H, D) layout."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).transpose(1, 2)
         for a in (q, k, v)]
    out = t_attn.flash_chunked(*t, chunk_k=chunk_k,
                               scale=q.shape[-1] ** -0.5,
                               cap=opts.get("softcap", 0.0),
                               window=opts.get("window", 0))
    return out.transpose(1, 2).numpy()


@pytest.mark.parametrize("s,d,hq,hkv", SHAPES)
@pytest.mark.parametrize("opts", OPTS)
def test_flash_attention_plain_versions_match_jax_ref(s, d, hq, hkv, opts):
    q, k, v = _qkv(s, d, hq, hkv, seed=s + hq)
    want = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **opts))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), **opts).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_chunked(q, k, v, **opts), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("opts", [{}, {"softcap": 5.0, "window": 17}])
def test_flash_attention_plain_matches_pallas_interpret(opts):
    q, k, v = _qkv(64, 32, 4, 2, seed=7)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32,
        block_k=32, interpret=True, **opts))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), **opts).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flash_attention_bf16():
    rng = np.random.default_rng(0)
    arrs = [jnp.asarray(rng.normal(size=(1, 2, 64, 32)), jnp.bfloat16)
            for _ in range(3)]
    want = np.asarray(j_ref(*arrs), np.float32)
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
         for a in arrs]
    got = flash_attention(*t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)
    got_c = t_attn.flash_chunked(*[a.transpose(1, 2) for a in t],
                                 chunk_k=32, scale=32 ** -0.5)
    assert got_c.dtype == torch.bfloat16
    np.testing.assert_allclose(got_c.transpose(1, 2).float().numpy(), want,
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("s,chunk_k", [(37, 512), (100, 32), (61, 16)])
@pytest.mark.parametrize("opts", [{}, {"softcap": 5.0, "window": 9}])
def test_ragged_sequence_length(s, chunk_k, opts):
    """S that is a multiple of no tile: the plain versions against the JAX
    reference and against the JAX ``flash_chunked`` (which halves its
    chunk until it divides S, as the port's does)."""
    q, k, v = _qkv(s, 24, 4, 2, seed=s)
    want = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **opts))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), **opts).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    port = _chunked(q, k, v, chunk_k=chunk_k, **opts)
    np.testing.assert_allclose(port, want, rtol=RTOL, atol=ATOL)
    jc = np.asarray(j_chunked(
        *[jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)], chunk_k=chunk_k,
        scale=24 ** -0.5, cap=opts.get("softcap", 0.0),
        window=opts.get("window", 0))).swapaxes(1, 2)
    np.testing.assert_allclose(port, jc, rtol=RTOL, atol=ATOL)


def test_flash_chunked_ref_offset_and_latent_values_match_jax():
    """What the plain version takes beyond B8: a query offset into a longer
    KV sequence (decode-style prefill) and Dv != D (MLA)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 40)).astype(np.float32)
    kw = dict(chunk_k=8, scale=0.25, cap=3.0, window=10, q_offset=16)
    want = np.asarray(j_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw))
    got = t_attn.flash_chunked(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.shape == (2, 8, 4, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_dispatch_on_device(monkeypatch):
    """CPU tensors run the plain versions and launch nothing; other
    devices raise; on the card, what B8 does not take raises before any
    launch."""
    q, k, v = map(torch.from_numpy, _qkv(16, 8, 2, 1, seed=1))
    kernels.reset_launches()
    flash_attention(q, k, v)
    t_attn.flash_chunked(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), scale=8 ** -0.5)
    assert kernels.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="device"):
        flash_attention(*[t.to("meta") for t in (q, k, v)])
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    qs, ks = q.transpose(1, 2), k.transpose(1, 2)
    with pytest.raises(NotImplementedError, match="Dv"):
        t_attn.flash_chunked(qs, ks, torch.zeros(1, 16, 1, 4), scale=1.0)
    with pytest.raises(NotImplementedError, match="q_offset"):
        t_attn.flash_chunked(qs, ks, v.transpose(1, 2), scale=1.0,
                             q_offset=4)
    assert kernels.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("bad", ["d", "heads", "dtype", "stride"])
def test_kernel_input_checks(bad):
    """B8's wrapper refuses what the kernel does not take (checked before
    any build or launch, so it runs here on meta tensors)."""
    from repro_torch.kernels.flash_attention import ops
    shape_q, shape_kv, dt = (1, 4, 16, 64), (1, 2, 16, 64), torch.float32
    if bad == "d":
        shape_q, shape_kv = (1, 4, 16, 12), (1, 2, 16, 12)
    if bad == "heads":
        shape_kv = (1, 3, 16, 64)
    if bad == "dtype":
        dt = torch.float16
    q = torch.empty(shape_q, dtype=dt, device="meta")
    k = torch.empty(shape_kv, dtype=dt, device="meta")
    if bad == "stride":
        q = torch.empty((1, 4, 64, 16), dtype=dt, device="meta").transpose(2, 3)
    with pytest.raises(ValueError):
        ops.launch(q, k, k, torch.empty_like(q), scale=1.0)
