"""B8's backward on the CPU: the plain backward ``flash_attention_bwd_ref``
(explicit formulas in float32) against autograd through the port's
``flash_chunked_ref`` and against ``jax.vjp`` of the JAX package's
``repro.models.attention.flash_chunked``; the gradients through
``models.attention.FlashAttention`` (what ``flash_chunked`` runs) equal
the plain backward's; and ``launch_bwd``, the wrapper of the CUDA kernel
(``csrc/flash_attention_bwd.cu``), on meta tensors with the C call
stubbed: it refuses what the kernel does not take before any launch, and
a CUDA tensor that requires grad goes through B8 forward and backward
kernels, each counted once.

Tolerance: float32, |got - want| <= RTOL * max|want| for each gradient
(the same float32 quantities summed in another order: measured at most
7.6e-7 of the largest entry, against autograd and against JAX alike).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models.attention import flash_chunked as j_chunked  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_bwd_ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

torch.set_num_threads(1)
RTOL = 5e-6
# (Hq, Hkv, D, Dv, S, chunk_k, softcap, window)
CASES = {
    "gqa_d32": (4, 2, 32, 32, 24, 8, 0.0, 0),
    "dv_ne_d": (4, 2, 48, 32, 24, 8, 0.0, 0),
    "softcap50": (4, 2, 32, 32, 24, 8, 50.0, 0),
    "softcap3": (2, 1, 16, 16, 24, 8, 3.0, 0),
    "window5": (4, 2, 32, 32, 24, 8, 0.0, 5),
    "ragged_s": (4, 2, 32, 32, 21, 8, 0.0, 0),
    "all": (6, 3, 40, 24, 19, 4, 20.0, 7),
}


def _inputs(hq, hkv, d, dv, s, seed=0):
    """q, k, v and the output gradient, (B, S, H, width) float32."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, s, h, w)).astype(np.float32)
            for h, w in ((hq, d), (hkv, d), (hkv, dv), (hq, dv))]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()), err


def _plain(q, k, v, g, s, d, cap, win, chunk_k):
    """flash_attention_bwd_ref on the (B, H, S, D) views, with the
    forward's output from flash_chunked_ref; grads back in (B, S, H, D)."""
    kw = dict(chunk_k=chunk_k, scale=d ** -0.5, cap=cap, window=win)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    out = t_attn.flash_chunked_ref(*t[:3], **kw)
    grads = flash_attention_bwd_ref(
        *[a.transpose(1, 2) for a in (*t[:3], out, t[3])],
        scale=kw["scale"], softcap=cap, window=win)
    return [a.transpose(1, 2) for a in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_autograd_and_jax(name):
    hq, hkv, d, dv, s, chunk_k, cap, win = CASES[name]
    q, k, v, g = _inputs(hq, hkv, d, dv, s)
    got = _plain(q, k, v, g, s, d, cap, win, chunk_k)
    kw = dict(chunk_k=chunk_k, scale=d ** -0.5, cap=cap, window=win)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = t_attn.flash_chunked_ref(*leaves, **kw)
    want_t = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b, c: j_chunked(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want_j = vjp(jnp.asarray(g))
    for a, b, c in zip(got, want_t, want_j):
        _close(a, b)
        _close(a, np.asarray(c))


@pytest.mark.parametrize("name", ["gqa_d32", "dv_ne_d", "softcap50",
                                  "window5"])
def test_flash_attention_function_runs_the_plain_backward(name):
    """flash_chunked on CPU tensors that require grad: the output has a
    grad_fn (FlashAttention's), and its gradients are the plain
    backward's bit for bit, through the model's (B, S, H, D) strides."""
    hq, hkv, d, dv, s, chunk_k, cap, win = CASES[name]
    q, k, v, g = _inputs(hq, hkv, d, dv, s, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = t_attn.flash_chunked(*leaves, chunk_k=chunk_k, scale=d ** -0.5,
                               cap=cap, window=win)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    want = _plain(q, k, v, g, s, d, cap, win, chunk_k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_function_keeps_nothing_without_grad():
    """FlashAttention saves q, k, v and the output only when grad mode is
    on and an input requires grad: under no_grad, inference_mode or with
    inputs that need no grad, nothing is packed for a backward."""
    q, k, v, _ = _inputs(4, 2, 16, 16, 12)
    packed = []

    def run(*tensors):
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: packed.append(t) or t, lambda t: t):
            return t_attn.flash_chunked(*tensors, chunk_k=4, scale=0.25)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    run(*leaves)
    assert len(packed) == 4
    packed.clear()
    with torch.no_grad():
        run(*leaves)
    with torch.inference_mode():
        run(*map(torch.from_numpy, (q, k, v)))
    out = run(*map(torch.from_numpy, (q, k, v)))
    assert packed == [] and out.grad_fn is None


def test_query_offset_on_the_cpu_differentiates_the_plain_version():
    """A query offset (not B8's self-attention) runs flash_chunked_ref
    itself on the CPU, differentiated by autograd."""
    q, k, v, g = _inputs(4, 2, 16, 16, 12)
    kv = [torch.from_numpy(np.concatenate([a, a], axis=1))
          .requires_grad_() for a in (k, v)]
    qt = torch.from_numpy(q).requires_grad_()
    out = t_attn.flash_chunked(qt, *kv, chunk_k=4, scale=0.25, q_offset=12)
    assert type(out.grad_fn).__name__ != "FlashAttentionBackward"
    grads = torch.autograd.grad(out, [qt, *kv], torch.from_numpy(g))
    assert all(torch.isfinite(x).all() for x in grads)


@pytest.fixture
def stubbed(monkeypatch):
    """Meta tensors as CUDA tensors: the device check answers 'cuda' and
    B8's forward and backward C calls are recorded instead of run."""
    calls = []
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    monkeypatch.setattr(ops, "_run", lambda entry, *a: calls.append(entry))
    monkeypatch.setattr(ops, "_run_bwd",
                        lambda *a: calls.append("repro_flash_attention_bwd"))
    kernels.reset_launches()
    return calls


@pytest.mark.parametrize("bad", ["d", "dv", "dtype", "dout_shape",
                                 "dout_dtype", "heads", "dout_stride"])
def test_launch_bwd_input_checks(stubbed, bad):
    """launch_bwd refuses before any launch: a width outside 8..256 in
    steps of 8 (D 12, Dv 264), float16, a dout of the wrong shape or
    dtype, Hq not a multiple of Hkv and a non-unit last stride."""
    b, hq, hkv, s, d, dv, dt = 1, 4, 2, 16, 32, 32, torch.float32
    if bad == "d":
        d = 12
    if bad == "dv":
        dv = 264
    if bad == "dtype":
        dt = torch.float16
    if bad == "heads":
        hkv = 3

    def empty(*shape, dtype=None):
        return torch.empty(shape, dtype=dtype or dt, device="meta")

    q, k, v = empty(b, hq, s, d), empty(b, hkv, s, d), empty(b, hkv, s, dv)
    out, dout = empty(b, hq, s, dv), empty(b, hq, s, dv)
    if bad == "dout_shape":
        dout = empty(b, hq, s + 1, dv)
    if bad == "dout_dtype":
        dout = empty(b, hq, s, dv, dtype=torch.bfloat16)
    if bad == "dout_stride":
        dout = empty(b, hq, dv, s).transpose(2, 3)
    with pytest.raises(ValueError):
        ops.launch_bwd(q, k, v, out, dout, scale=1.0)
    assert stubbed == [] and sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype,d,dv,route", [
    (torch.float32, 32, 32, "simt"), (torch.bfloat16, 64, 64, "wgmma"),
    (torch.float32, 64, 64, "tf32"), (torch.bfloat16, 192, 128, "wgmma"),
    (torch.bfloat16, 96, 96, "simt")])
def test_cuda_tensor_that_requires_grad_launches_b8_bwd(stubbed, dtype, d,
                                                         dv, route):
    """On a CUDA tensor that requires grad, flash_chunked returns a tensor
    whose grad_fn is FlashAttention's; its backward launches B8's backward
    kernel once (whatever route the forward took) and nothing else, and
    the gradients come back in the model's (B, S, H, D) layout."""
    q = torch.empty((2, 24, 4, d), dtype=dtype, device="meta",
                    requires_grad=True)
    k = torch.empty((2, 24, 2, d), dtype=dtype, device="meta",
                    requires_grad=True)
    v = torch.empty((2, 24, 2, dv), dtype=dtype, device="meta",
                    requires_grad=True)
    out = t_attn.flash_chunked(q, k, v, scale=d ** -0.5)
    assert stubbed == [f"repro_flash_attention_{route}"]
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert stubbed[1:] == ["repro_flash_attention_bwd"]
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1
    assert kernels.LAUNCHES[f"flash_attention_{route}"] == 1
    assert sum(kernels.LAUNCHES.values()) == 2
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    with torch.no_grad():
        t_attn.flash_chunked(q, k, v, scale=d ** -0.5)
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1
