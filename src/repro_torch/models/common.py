"""Shared model primitives: norms, activations, RoPE and initialisers
(port of ``repro.models.common``).

Each function rounds to the input's dtype where the JAX function does:
``rms_norm``, ``gelu``, ``softcap`` and ``apply_rope`` compute in float32
and cast back, and ``swiglu`` rounds silu to the gate's dtype before the
product.  The initialisers draw ``jax.random.normal`` through
``core.threefry``, so a key gives the JAX package's weights within
``normal``'s 4 ulps.

``ShardCtx`` and ``cross_entropy_chunked`` are not ported: the port runs
one device (no sharding constraints) and only the forward pass.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import threefry

def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``param_dtype``/``compute_dtype``
    (a numpy-style name such as "float32" or "bfloat16")."""
    return getattr(torch, name)


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
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                 # (head_dim/2,)


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


def dense_init(key, shape, dtype, fan_in: Optional[int] = None, *,
               device=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    std = fan_in ** -0.5
    return (threefry.normal(key, tuple(shape), device=device) * std).to(dtype)


def embed_init(key, shape, dtype, *, device=None):
    return threefry.normal(key, tuple(shape), device=device).to(dtype)
