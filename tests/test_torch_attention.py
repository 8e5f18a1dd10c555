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
both, as in ``tests/test_kernels.py``).  The CUDA kernels themselves are
held to the plain version on the card by ``chip_smoke.py`` (phase h);
here the wrappers' choice between them (by dtype and D) and their input
checks run with the launch stubbed.
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
    KV sequence (decode-style prefill), here with Dv != D (MLA)."""
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


B8_KEYS = ("flash_attention_wgmma", "flash_attention_tf32",
           "flash_attention_simt")


@pytest.fixture
def launched(monkeypatch):
    """Stub B8's C call on meta tensors: record the entry each launch
    would call, with the device check answering 'cuda'."""
    from repro_torch.kernels.flash_attention import ops
    entries = []
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    monkeypatch.setattr(ops, "_run", lambda entry, *a: entries.append(entry))
    kernels.reset_launches()
    return entries


def test_dispatch_on_device(monkeypatch):
    """CPU tensors run the plain versions and launch nothing; other
    devices raise; on the card, what B8 does not take raises before any
    launch: a value width Dv that no kernel takes (4: the SIMT kernel
    takes 8..256 in steps of 8) and a query offset."""
    q, k, v = map(torch.from_numpy, _qkv(16, 8, 2, 1, seed=1))
    kernels.reset_launches()
    flash_attention(q, k, v)
    t_attn.flash_chunked(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), scale=8 ** -0.5)
    assert all(kernels.LAUNCHES[key] == 0 for key in B8_KEYS)
    with pytest.raises(ValueError, match="device"):
        flash_attention(*[t.to("meta") for t in (q, k, v)])
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    qs, ks = q.transpose(1, 2), k.transpose(1, 2)
    with pytest.raises(ValueError, match="Dv = 4"):
        t_attn.flash_chunked(qs, ks, torch.zeros(2, 16, 1, 4), scale=1.0)
    with pytest.raises(NotImplementedError, match="q_offset"):
        t_attn.flash_chunked(qs, ks, v.transpose(1, 2), scale=1.0,
                             q_offset=4)
    assert all(kernels.LAUNCHES[key] == 0 for key in B8_KEYS)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 192, "simt"), (torch.float32, 64, "tf32"),
    (torch.float32, 256, "simt"), (torch.float32, 128, "tf32"),
    (torch.float32, 96, "simt"), (torch.float32, 32, "simt"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 96, "simt"),
    (torch.float32, 80, "simt")])
def test_dispatch_by_dtype_and_d(launched, dtype, d, route):
    """A CUDA tensor takes the kernel its dtype and D name, and counts the
    launch under that kernel's key only: bf16 at D 64, 80 (Zamba2-2.7B's
    shared block), 128 and 256 the tensor-core kernel, float32 at D 64
    and 128 the float32 tensor-core kernel (3xTF32), the rest the SIMT
    kernel (bf16 at D 32, 96 and 192, float32 at D 80 among them); so
    does the model path (flash_chunked on the (B, S, H, D) layout,
    through strides)."""
    from repro_torch.kernels.flash_attention import ops
    assert ops.kernel_route(dtype, d) == route
    q = torch.empty((2, 4, 24, d), dtype=dtype, device="meta")
    kv = torch.empty((2, 2, 24, d), dtype=dtype, device="meta")
    out = flash_attention(q, kv, kv)
    assert out.shape == q.shape and out.dtype == dtype
    t_attn.flash_chunked(q.transpose(1, 2), kv.transpose(1, 2),
                         kv.transpose(1, 2), scale=d ** -0.5)
    assert launched == [f"repro_flash_attention_{route}"] * 2
    assert kernels.LAUNCHES[f"flash_attention_{route}"] == 2
    assert sum(kernels.LAUNCHES[key] for key in B8_KEYS) == 2


def test_tma_stride_raises_without_fallback(launched):
    """An s stride of 68 bf16 (136 bytes) is no multiple of 16 bytes: the
    tensor-core kernel refuses it, and ``launch`` raises rather than run
    the SIMT kernel; the SIMT kernel itself takes it."""
    from repro_torch.kernels.flash_attention import ops
    q = torch.empty((1, 4, 16, 68), dtype=torch.bfloat16,
                    device="meta")[..., :64]
    kv = torch.empty((1, 2, 16, 64), dtype=torch.bfloat16, device="meta")
    out = torch.empty((1, 4, 16, 64), dtype=torch.bfloat16, device="meta")
    for fn in (ops.launch, ops.launch_wgmma):
        with pytest.raises(ValueError, match="TMA"):
            fn(q, kv, kv, out, scale=1.0)
    assert launched == []
    ops.launch_simt(q, kv, kv, out, scale=1.0)
    assert launched == ["repro_flash_attention_simt"]


def test_tf32_tma_stride_raises_without_fallback(launched):
    """float32 at D 64 routes to the float32 tensor-core kernel; an s
    stride of 65 floats (260 bytes) is no multiple of 16 bytes, so it
    raises there and through ``launch``, rather than run the SIMT kernel,
    which takes it."""
    from repro_torch.kernels.flash_attention import ops
    assert ops.kernel_route(torch.float32, 64) == "tf32"
    q = torch.empty((1, 4, 16, 65), device="meta")[..., :64]
    kv = torch.empty((1, 2, 16, 64), device="meta")
    out = torch.empty((1, 4, 16, 64), device="meta")
    for fn in (ops.launch, ops.launch_tf32):
        with pytest.raises(ValueError, match="TMA"):
            fn(q, kv, kv, out, scale=1.0)
    assert launched == []
    ops.launch_simt(q, kv, kv, out, scale=1.0)
    assert launched == ["repro_flash_attention_simt"]
    assert kernels.LAUNCHES["flash_attention_tf32"] == 0


@pytest.mark.parametrize("bad", ["d", "heads", "dtype", "stride",
                                 "wgmma_d", "wgmma_dtype", "tma_stride",
                                 "tf32_d", "tf32_dtype", "wgmma_d80_dv64"])
def test_kernel_input_checks(launched, bad):
    """B8's wrappers refuse what their kernels do not take (checked before
    any build or launch, so it runs here on meta tensors): the tensor-core
    kernel has no instance at (96, 96) or (80, 64), though it has one at
    (80, 80)."""
    from repro_torch.kernels.flash_attention import ops
    shape_q, shape_kv, dt = (1, 4, 16, 64), (1, 2, 16, 64), torch.float32
    dv = None
    fn = ops.launch
    if bad == "d":
        shape_q, shape_kv = (1, 4, 16, 12), (1, 2, 16, 12)
    if bad == "heads":
        shape_kv = (1, 3, 16, 64)
    if bad == "dtype":
        dt = torch.float16
    if bad == "wgmma_d":
        shape_q, shape_kv, dt = (1, 4, 16, 96), (1, 2, 16, 96), torch.bfloat16
        fn = ops.launch_wgmma
    if bad == "wgmma_dtype":
        fn = ops.launch_wgmma
    if bad == "wgmma_d80_dv64":
        shape_q, shape_kv, dt = (1, 4, 16, 80), (1, 2, 16, 80), torch.bfloat16
        dv, fn = 64, ops.launch_wgmma
    if bad == "tf32_d":
        shape_q, shape_kv = (1, 4, 16, 96), (1, 2, 16, 96)
        fn = ops.launch_tf32
    if bad == "tf32_dtype":
        dt = torch.bfloat16
        fn = ops.launch_tf32
    q = torch.empty(shape_q, dtype=dt, device="meta")
    k = torch.empty(shape_kv, dtype=dt, device="meta")
    if bad == "stride":
        q = torch.empty((1, 4, 64, 16), dtype=dt, device="meta").transpose(2, 3)
    if bad == "tma_stride":
        k = torch.empty((1, 2, 16, 68), dtype=torch.bfloat16,
                        device="meta")[..., :64]
        q = torch.empty(shape_q, dtype=torch.bfloat16, device="meta")
    v, out = k, torch.empty_like(q)
    if dv is not None:
        v = torch.empty((*shape_kv[:3], dv), dtype=dt, device="meta")
        out = torch.empty((*shape_q[:3], dv), dtype=dt, device="meta")
    with pytest.raises(ValueError):
        fn(q, k, v, out, scale=1.0)
    assert launched == [] and sum(kernels.LAUNCHES.values()) == 0
