"""The arithmetic of B8's tensor-core kernel against the JAX package on the
CPU.

``flash_attention_split_p_ref`` is that arithmetic in plain PyTorch: fp32
scores of bf16 q and k, an online softmax over tiles of 64 keys, and P.V as
p_hi.V + p_lo.V (p_hi = bf16(p), p_lo = bf16(p - p_hi)).  It is held to
``repro.kernels.flash_attention.ref.flash_attention_ref`` in bfloat16 over
the sweep of ``tests/test_torch_attention.py`` (its shapes at D = 64, 80
and 128, x {none, softcap, window, both}) with the check that
``chip_smoke.py`` phase (h) applies to the kernel: within 1e-5 of the
largest |out| plus one bf16 ulp (2^-7 relative) of the larger of the two
values.  The variant not taken, P rounded once to bf16, fails that check
at MusicGen-large's head width and a prefill length (S 1500); the split
passes there.

At D = 80 (Zamba2-2.7B's shared block) the kernel's Q and K tiles are two
boxes of 64 columns whose second overhangs the row (TMA fills columns
80-127 with zeros), S runs over five k-steps of 16 columns, and P.V over
V's first 64 columns and its last 16 by two products.  Zero columns add
exact zeros to every score, so the arithmetic is the split-P reference's
on the unpadded operands.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_split_p_ref)

torch.set_num_threads(1)
TOL_ATTN_F32 = 1e-5          # chip_smoke.py's, of the largest |out|
BF16_ULP = 2.0 ** -7         # one bf16 ulp, relative, at the binade's foot
SHAPES = [(64, 4, 2), (96, 8, 8), (128, 6, 1)]    # (S, Hq, Hkv)
OPTS = [{}, {"softcap": 10.0}, {"window": 23}, {"softcap": 5.0, "window": 17}]


def _bf16_qkv(s, d, hq, hkv, seed, b=2):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, s, d)) for h in (hq, hkv, hkv)]
    return [jnp.asarray(a, jnp.bfloat16) for a in arrs]


def _fail_share(got, want):
    """Share of outputs outside phase (h)'s check."""
    g, w = got.float(), want.float()
    tol = TOL_ATTN_F32 * float(w.abs().max()) + \
        BF16_ULP * torch.maximum(g.abs(), w.abs())
    return float(((g - w).abs() > tol).float().mean())


def _run(q, k, v, **kw):
    want = torch.from_numpy(np.asarray(j_ref(q, k, v, **kw), np.float32))
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
         for a in (q, k, v)]
    return t, want


@pytest.mark.parametrize("s,hq,hkv", SHAPES)
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("opts", OPTS)
def test_split_p_matches_jax_ref(s, hq, hkv, d, opts):
    (q, k, v), want = _run(*_bf16_qkv(s, d, hq, hkv, seed=s + d), **opts)
    got = flash_attention_split_p_ref(q, k, v, **opts)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _fail_share(got, want) == 0.0


def test_single_rounded_p_fails_where_split_passes():
    """B 1, 4 heads, S 1500, D 64 (MusicGen-large's head, 30 s of frames):
    P rounded once to bf16 puts several percent of the outputs outside the
    check (8% measured), the split none."""
    (q, k, v), want = _run(*_bf16_qkv(1500, 64, 4, 4, seed=0, b=1))
    assert _fail_share(flash_attention_split_p_ref(q, k, v), want) == 0.0
    single = flash_attention_split_p_ref(q, k, v, split_p=False)
    assert _fail_share(single, want) > 0.02
