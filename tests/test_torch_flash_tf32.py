"""The arithmetic of B8's float32 tensor-core kernel against the JAX package
on the CPU.

``flash_attention_tf32_ref`` is that arithmetic in plain PyTorch: every
float32 operand of Q K^T and P V split into tf32 parts, x = hi + lo (each
rounded to 10 fraction bits, to nearest with ties away from zero, on the
bits), the products hi.lo + lo.hi + hi.hi summed in float32 (lo.lo
dropped), an online softmax over the kernel's key tiles (64 at D = 64, 32
at D = 128).  It is held to
``repro.kernels.flash_attention.ref.flash_attention_ref`` in float32 over
the sweep of ``tests/test_torch_attention.py`` (its shapes at D = 64 and
128, x {none, softcap, window, both}) with the check ``chip_smoke.py``
phase (h) applies to the kernel: within TOL_ATTN_F32 = 1e-5 of the
largest |out|.  The variants not taken, one TF32 pass or either cross term
dropped, fail that check at MusicGen-large's head width and a prefill
length (S 1500); the three products pass there.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    TF32_TERMS, flash_attention_tf32_ref, tf32_rna)

torch.set_num_threads(1)
TOL_ATTN_F32 = 1e-5          # chip_smoke.py's, of the largest |out|
SHAPES = [(64, 4, 2), (96, 8, 8), (128, 6, 1)]    # (S, Hq, Hkv)
OPTS = [{}, {"softcap": 10.0}, {"window": 23}, {"softcap": 5.0, "window": 17}]


def _run(s, d, hq, hkv, seed, b=2, **opts):
    """Normal float32 q, k, v (as chip_smoke.py draws them), the JAX
    reference's output and the largest error that the check allows."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]
    want = torch.from_numpy(np.array(j_ref(*map(jnp.asarray, arrs), **opts)))
    return [torch.from_numpy(a) for a in arrs], want, \
        TOL_ATTN_F32 * float(want.abs().max())


@pytest.mark.parametrize("s,hq,hkv", SHAPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("opts", OPTS)
def test_tf32_products_match_jax_ref(s, hq, hkv, d, opts):
    (q, k, v), want, tol = _run(s, d, hq, hkv, seed=s + d, **opts)
    got = flash_attention_tf32_ref(q, k, v, **opts)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert float((got - want).abs().max()) <= tol


def test_three_products_pass_at_prefill_length():
    """B 1, 4 heads, S 1500, D 64 (MusicGen-large's head, 30 s of frames):
    hi.lo + lo.hi + hi.hi within the check (1.0e-6 against 2.9e-5 here)."""
    (q, k, v), want, tol = _run(1500, 64, 4, 4, seed=0, b=1)
    got = flash_attention_tf32_ref(q, k, v, terms=TF32_TERMS)
    assert float((got - want).abs().max()) <= tol / 10


@pytest.mark.parametrize("terms", [("hh",), ("hl", "hh"), ("lh", "hh")])
def test_variants_not_taken_fail(terms):
    """One TF32 pass, or a cross term dropped, misses the check at the same
    shape by more than an order of magnitude (7e-4 to 1.2e-3 against
    2.9e-5)."""
    (q, k, v), want, tol = _run(1500, 64, 4, 4, seed=0, b=1)
    got = flash_attention_tf32_ref(q, k, v, terms=terms)
    assert float((got - want).abs().max()) > 10 * tol


def test_tf32_rounding():
    """Ten fraction bits, ties away from zero on either sign, low 13 bits
    zero; x - hi is exact and hi + lo carries x to within 2^-21 of it."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4, 3.0, 0.0])
    assert tf32_rna(x).tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0,
                                    1 + one_ulp, 3.0, 0.0]
    r = torch.from_numpy(np.random.default_rng(0).normal(
        size=10_000).astype(np.float32) * 100)
    hi = tf32_rna(r)
    lo = tf32_rna(r - hi)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal((r.double() - hi.double()).float(), r - hi)
    err = (r.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * r.double().abs()).all())
