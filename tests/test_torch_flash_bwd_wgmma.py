"""B8-bwd's tensor-core kernel (``csrc/flash_attention_bwd_wgmma.cu``) on the
CPU: its arithmetic against the JAX package, and its route.

``flash_attention_bwd_split_ref`` is that arithmetic in plain PyTorch: lse
by an online max and sum over tiles of 64 keys, float32 scores and dP of
bf16 values, and P and dS entering dV = P^T dO, dK = dS^T Q and dQ = dS K as
p_hi + p_lo (p_hi = bf16(p), p_lo = bf16(p - p_hi)), summed over the
kernel's tiles in its order.  It is held to ``jax.vjp`` of
``repro.models.attention.flash_chunked`` in float32 on bf16-valued inputs
at every (D, Dv) the kernel takes, x {none, softcap, window, both}, with
GQA and a ragged S over two or three tiles, with the check that
``chip_smoke.py`` phase (q1) applies to the kernel: within 1e-4
(TOL_ATTN_BWD_F32) of the largest |entry| plus 2^-7 of the larger of the
two values (the gradients are rounded to bf16 once).  The forward's output
enters in float32, as JAX's gradient sees it: on the card the kernel gets
the forward's bf16 output, and phase (q1) holds it to
``flash_attention_bwd_ref`` given that same output.  The variant not
taken, P and dS rounded once to bf16, misses the check at MusicGen-large's
head width where the split passes.  The tile order it follows
(``BWD_WGMMA_PLAN``) is read against the kernel launcher's table.

The route, on meta tensors with the C calls stubbed: ``bwd_route`` for
every pair of ``WGMMA_DV`` and for pairs and dtypes of the SIMT kernel;
one launch counted under its own key; the padded lse scratch; a view that
TMA cannot read raises before any launch; ``FlashAttention``'s backward
copies only a dout that TMA cannot read.
"""
import os
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models.attention import flash_chunked as j_chunked  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    BWD_WGMMA_PLAN, flash_attention_bwd_split_ref, flash_attention_ref)
from repro_torch.models import attention as t_attn  # noqa: E402

torch.set_num_threads(1)
TOL_ATTN_BWD_F32 = 1e-4      # chip_smoke.py's, of the largest |entry|
BF16_ULP = 2.0 ** -7         # one bf16 ulp, relative, at the binade's foot
# (D, Dv, S): S over two or three tiles of 64, the last one ragged
WIDTHS = [(64, 64, 100), (80, 80, 100), (128, 128, 130), (192, 128, 130),
          (256, 256, 100)]
OPTS = [{}, {"softcap": 10.0}, {"window": 23}, {"softcap": 5.0, "window": 17}]


def _bf16_inputs(s, d, dv, hq, hkv, seed, b=1):
    """q, k, v and dout, (B, S, H, width) float32 holding bf16 values."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, h, w)).astype(np.float32))
            .bfloat16().float().numpy()
            for h, w in ((hq, d), (hkv, d), (hkv, dv), (hq, dv))]


def _fail_share(got, want):
    """Share of a gradient's entries outside phase (q1)'s check."""
    g, w = got.float(), want.float()
    tol = TOL_ATTN_BWD_F32 * float(w.abs().max()) + \
        BF16_ULP * torch.maximum(g.abs(), w.abs())
    return float(((g - w).abs() > tol).float().mean())


def _shares(arrs, softcap=0.0, window=0, split=True):
    """Each gradient's share outside the check: the split arithmetic (or
    the single-rounded variant) against jax.vjp of flash_chunked."""
    q, k, v, g = arrs
    d = q.shape[-1]
    kw = dict(chunk_k=64, scale=d ** -0.5, cap=softcap, window=window)
    _, vjp = jax.vjp(lambda a, b, c: j_chunked(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = [torch.from_numpy(np.array(x)).transpose(1, 2)
            for x in vjp(jnp.asarray(g))]
    tq, tk, tv, tg = (torch.from_numpy(a).transpose(1, 2) for a in arrs)
    out = flash_attention_ref(tq, tk, tv, scale=kw["scale"], softcap=softcap,
                              window=window)
    got = flash_attention_bwd_split_ref(
        tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), out, tg.bfloat16(),
        scale=kw["scale"], softcap=softcap, window=window, split=split)
    assert [x.dtype for x in got] == [torch.bfloat16] * 3
    assert [x.shape for x in got] == [x.shape for x in want]
    return [_fail_share(a, b) for a, b in zip(got, want)]


@pytest.mark.parametrize("d,dv,s", WIDTHS)
@pytest.mark.parametrize("opts", OPTS)
def test_split_arithmetic_matches_jax_vjp(d, dv, s, opts):
    arrs = _bf16_inputs(s, d, dv, 4, 2, seed=s + d)
    assert _shares(arrs, **opts) == [0.0, 0.0, 0.0]


def test_single_rounded_p_and_ds_fail_where_split_passes():
    """B 1, 4 heads of 64 (MusicGen-large's), S 512: P and dS rounded once
    to bf16 put dQ, dK and dV outside the check (2%, 1.4% and 0.4% of the
    entries measured), the split none."""
    arrs = _bf16_inputs(512, 64, 64, 4, 4, seed=0)
    assert _shares(arrs) == [0.0, 0.0, 0.0]
    assert all(x > 1e-3 for x in _shares(arrs, split=False))


def test_plan_mirrors_the_launcher_table():
    """``BWD_WGMMA_PLAN``, the tile order of the plain arithmetic, is the
    table at the end of the kernel's source for every pair of WGMMA_DV:
    dkdv's warpgroups alternate query tiles where they do not split dK
    from dV, then dkdv's and dq's chunks."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src", "repro_torch", "csrc",
                       "flash_attention_bwd_wgmma.cu")
    with open(src) as f:
        table = {(int(d), int(dv)): (split == "false", int(kv), int(q))
                 for d, dv, split, kv, q in re.findall(
                     r"launch<(\d+), (\d+), (true|false), (\d+), (\d+)>",
                     f.read())}
    assert table == BWD_WGMMA_PLAN
    assert sorted(table) == sorted(ops.WGMMA_DV)


@pytest.fixture
def stubbed(monkeypatch):
    """Meta tensors as CUDA tensors: the device check answers 'cuda' and
    B8's C calls are recorded (entry, dout's strides, lse's shape) instead
    of run."""
    calls = []
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    monkeypatch.setattr(ops, "_run", lambda entry, *a: calls.append(entry))
    monkeypatch.setattr(
        ops, "_run_bwd", lambda entry, tensors, lse, *a: calls.append(
            (entry, tensors[4].stride(), tuple(lse.shape))))
    kernels.reset_launches()
    return calls


def _views(dtype, d, dv, s=100, hq=4, hkv=2, b=2):
    def empty(h, w):
        return torch.empty((b, h, s, w), dtype=dtype, device="meta")
    return empty(hq, d), empty(hkv, d), empty(hkv, dv), empty(hq, dv), \
        empty(hq, dv)


@pytest.mark.parametrize("d,dv", ops.WGMMA_DV)
def test_bf16_at_the_tensor_core_widths_takes_the_wgmma_backward(stubbed, d,
                                                                 dv):
    """bf16 at each pair of WGMMA_DV: one launch of the tensor-core
    backward, counted under its own key, its lse and delta scratch padded
    to 128 rows (S 100); float32 at the same pair takes the SIMT one."""
    assert ops.bwd_route(torch.bfloat16, d, dv) == "wgmma"
    grads = ops.launch_bwd(*_views(torch.bfloat16, d, dv), scale=1.0)
    assert stubbed == [("repro_flash_attention_bwd_wgmma",
                        (4 * 100 * dv, 100 * dv, dv, 1), (2, 4, 128))]
    assert kernels.LAUNCHES["flash_attention_bwd_wgmma"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert [g.shape for g in grads] == [(2, 4, 100, d), (2, 2, 100, d),
                                        (2, 2, 100, dv)]
    assert ops.bwd_route(torch.float32, d, dv) == "simt"


@pytest.mark.parametrize("dtype,d,dv", [
    (torch.float32, 32, 32), (torch.float32, 64, 64),
    (torch.float32, 128, 128), (torch.bfloat16, 32, 32),
    (torch.bfloat16, 96, 96), (torch.bfloat16, 128, 64),
    (torch.bfloat16, 192, 192)])
def test_other_dtypes_and_widths_take_the_simt_backward(stubbed, dtype, d,
                                                        dv):
    """Every other dtype and pair: one launch of the SIMT backward under
    ``flash_attention_bwd``, its scratch (B, Hq, S) unpadded."""
    assert ops.bwd_route(dtype, d, dv) == "simt"
    ops.launch_bwd(*_views(dtype, d, dv), scale=1.0)
    assert stubbed == [("repro_flash_attention_bwd",
                        (4 * 100 * dv, 100 * dv, dv, 1), (2, 4, 100))]
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1


@pytest.mark.parametrize("bad", ["q", "k", "v", "out", "dout"])
def test_a_view_tma_cannot_read_raises_before_any_launch(stubbed, bad):
    """A bf16 view at (64, 64) whose s stride is 68 elements (136 bytes, no
    multiple of 16) raises on the tensor-core route: no launch, no SIMT
    kernel in its place."""
    views = dict(zip(("q", "k", "v", "out", "dout"),
                     _views(torch.bfloat16, 64, 64)))
    t = views[bad]
    views[bad] = torch.empty((*t.shape[:3], 68), dtype=t.dtype,
                             device="meta")[..., :64]
    with pytest.raises(ValueError, match="TMA"):
        ops.launch_bwd(*views.values(), scale=1.0)
    assert stubbed == [] and sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype,d,dv", [
    (torch.float32, 64, 64), (torch.bfloat16, 96, 96),
    (torch.bfloat16, 128, 64)])
def test_the_wgmma_backward_refuses_what_it_does_not_take(stubbed, dtype, d,
                                                          dv):
    with pytest.raises(ValueError):
        ops.launch_bwd_wgmma(*_views(dtype, d, dv), scale=1.0)
    assert stubbed == [] and sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("width,copied", [(68, True), (72, False),
                                          (64, False)])
def test_function_copies_only_a_dout_tma_cannot_read(stubbed, width,
                                                     copied):
    """flash_chunked on bf16 (64, 64) views that require grad: a gradient
    handed over as a (B, S, H, width)[..., :64] view goes to the
    tensor-core backward through its own strides when TMA reads them
    (width 72: rows of 144 bytes) and as a contiguous copy when it cannot
    (width 68: 136 bytes)."""
    q, k, v = (torch.empty((2, 24, h, 64), dtype=torch.bfloat16,
                           device="meta", requires_grad=True)
               for h in (4, 2, 2))
    out = t_attn.flash_chunked(q, k, v, scale=0.125)
    g = torch.empty((2, 24, 4, width), dtype=torch.bfloat16,
                    device="meta")[..., :64]
    torch.autograd.grad(out, (q, k, v), g)
    want = (6144, 64, 256, 1) if copied else g.transpose(1, 2).stride()
    assert stubbed[1:] == [("repro_flash_attention_bwd_wgmma", want,
                            (2, 4, 64))]
    assert kernels.LAUNCHES["flash_attention_bwd_wgmma"] == 1
