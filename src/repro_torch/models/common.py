"""Shared model primitives: norms, activations, RoPE and initialisers
(port of ``repro.models.common``).

Each function rounds to the input's dtype where the JAX function does:
``rms_norm``, ``gelu``, ``softcap`` and ``apply_rope`` compute in float32
and cast back, and ``swiglu`` rounds silu to the gate's dtype before the
product.  The initialisers draw ``jax.random.normal`` through
``core.threefry``, so a key gives the JAX package's weights within
``normal``'s 4 ulps.

``matmul_cd`` is the LM forward's product in the compute dtype, rounded
once from a float32 sum as XLA's dot is.  ``cross_entropy_chunked`` is the
train loss over sequence chunks.

``ShardCtx`` is not ported: the port runs one device (no sharding
constraints).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import threefry

def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``param_dtype``/``compute_dtype``
    (a numpy-style name such as "float32" or "bfloat16")."""
    return getattr(torch, name)


def matmul_cd(a, b):
    """``a @ b`` in the operands' (compute) dtype, as XLA computes a dot:
    the products summed in float32 and the sum rounded once.

    A bfloat16 product on the CPU is taken in float32 and cast back, since
    torch's CPU bfloat16 GEMM (oneDNN on AMX/AVX512-BF16 cores) does not
    round once in every entry, and whether it does depends on the machine.
    On the card a bfloat16 ``torch.matmul`` is cuBLAS with a float32
    accumulator, rounded once when
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    is False.  A float32 product is a plain matmul on both devices.
    """
    if a.dtype == torch.bfloat16 and a.device.type == "cpu":
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b


def proj_heads(h, w, cd):
    """einsum('bsd,dhk->bshk') as one matmul in the compute dtype: h (B,
    S, d) against w (d, H, k)."""
    return matmul_cd(h, w.to(cd).reshape(w.shape[0], -1)).reshape(
        *h.shape[:2], *w.shape[1:])


# --------------------------------------------------------------------------
# Norms / activations


def rms_norm(x, scale, eps: float = 1e-6, *, plus_one: bool = False):
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if plus_one else scale.float()
    return (y * s).to(dtype)


def swiglu(gate, up):
    return F.silu(gate.float()).to(gate.dtype) * up


def gelu(x):
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def softcap(x, cap: float):
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    """The (head_dim / 2,) inverse frequencies, one table a (head_dim,
    theta, device) made once: every layer of a decode step asks for it, and
    building it is four launches each time."""
    return _rope_freqs(head_dim, float(theta), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=32)
def _rope_freqs(head_dim: int, theta: float, device: torch.device):
    # a normal tensor, even when first asked for inside inference mode
    with torch.inference_mode(False):
        exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                                 device=device) / head_dim
        return 1.0 / (theta ** exponents)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)     # (d/2,)
    ang = positions[..., None].float() * freqs        # (..., S, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == ang.ndim + 1:                        # (..., S, H, D)
        cos, sin = cos[..., None, :], sin[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., ::2], x32[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Initialisers (threefry keys: see core.threefry)


# elements drawn at a time: a draw of more (DeepSeek-V2's expert stacks
# hold 1.26 G each) is made in pieces of this many, so that threefry's
# int64 temporaries stay near 0.5 GB each instead of 10 GB
DRAW_CHUNK = 1 << 26


def _normal_init(key, shape, dtype, scale, device):
    """``(normal(key, shape) [* scale]).to(dtype)``, drawn in pieces of
    ``DRAW_CHUNK`` flat elements: the same numbers, element for element."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n <= DRAW_CHUNK:
        x = threefry.normal(key, shape, device=device)
        return (x if scale is None else x * scale).to(dtype)
    dev = torch.as_tensor(key).device if device is None else device
    out = torch.empty(n, dtype=dtype, device=dev)
    for a in range(0, n, DRAW_CHUNK):
        m = min(DRAW_CHUNK, n - a)
        x = threefry.normal(key, (m,), device=dev, start=a)
        out[a:a + m] = (x if scale is None else x * scale).to(dtype)
    return out.reshape(shape)


def dense_init(key, shape, dtype, fan_in: Optional[int] = None, *,
               device=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return _normal_init(key, shape, dtype, fan_in ** -0.5, device)


def embed_init(key, shape, dtype, *, device=None):
    return _normal_init(key, shape, dtype, None, device)


# --------------------------------------------------------------------------
# Loss


def cross_entropy_chunked(logits_fn, hidden, labels, *, n_chunks: int = 1,
                          final_softcap: float = 0.0, valid=None):
    """Causal-LM CE computed over sequence chunks.

    logits_fn: hidden chunk (B, s, D) -> logits (B, s, V).  Chunking bounds
    the peak (B, s, V) activation (256k-vocab archs).  Logits, softcap,
    log-sum-exp and the ``valid`` mask (B, S) in float32; the chunks' sums
    added in order from zero, as the JAX scan adds them.
    Returns (mean_nll, n_tokens).
    """
    B, S, _ = hidden.shape
    assert S % n_chunks == 0
    s = S // n_chunks
    if valid is None:
        valid = torch.ones((B, S), dtype=torch.bool, device=hidden.device)
    valid = valid.float()

    def one(h, y, v):
        logits = logits_fn(h).float()
        if final_softcap:
            logits = final_softcap * torch.tanh(logits / final_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, y[..., None].long())[..., 0]
        nll = (lse - gold) * v
        return nll.sum(), v.sum()

    if n_chunks == 1:
        tot, cnt = one(hidden, labels, valid)
    else:
        tot = cnt = torch.zeros((), dtype=torch.float32,
                                device=hidden.device)
        for i in range(n_chunks):
            t, c = one(hidden[:, i * s:(i + 1) * s],
                       labels[:, i * s:(i + 1) * s],
                       valid[:, i * s:(i + 1) * s])
            tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0), cnt
