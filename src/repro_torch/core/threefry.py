"""The subset of ``jax.random`` that the JAX package calls, bit for bit.

Keys are raw threefry ``PRNGKey`` keys: two uint32 words, carried as an
int64 tensor of shape (2,) that holds each word's 32-bit pattern (the
port's state carries its key the same way).  Every function here reproduces
``jax.random`` under jax 0.9's default ``jax_threefry_partitionable=True``
layout, which is what the JAX package runs with:

  * ``random_bits(key, shape)``: element ``i`` (flat index) hashes the
    counter pair (hi, lo) = (i >> 32, i & 0xFFFFFFFF) with
    ``threefry2x32`` and returns the xor of the two output words;
  * ``split(key, num)``: the same counters over (num,); key j is the pair
    of output words (not their xor);
  * ``fold_in(key, d)``: ``threefry2x32(key, 0, d)``.

As in ``core.knn``'s counter hash, the arithmetic runs on int64 tensors
holding 32-bit patterns, so shifts are logical and sums are masked back to
32 bits; threefry needs only add, rotate and xor.  Public draws return
int32 (``randint``), float32 (``uniform``, ``normal``) or bool
(``bernoulli``) tensors, as the JAX functions do.

A key may lie on any device, and a draw is made on ``device`` (default:
the key's).  A key on the CPU feeds a draw on the card as Python ints, so
a step can run its scalar key chain (``fold_in``, ``split``) on the host
from words it already read and make only the bulk draws on the card.

``uniform``, ``bernoulli``, ``randint``, ``split``, ``fold_in`` and
``random_bits`` are exact.  ``normal`` is ``sqrt(2) * erf_inv(u)`` with
XLA's float32 ``erf_inv`` (Giles' single-precision polynomial) ported
term for term; ``log1p`` and the polynomial's contraction into fused
multiply-adds may round differently from XLA's, so ``normal`` is held to
JAX within 4 float32 ulps of the result, not bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on counter words.

    ``key`` is a pair of words (ints or tensors, 32-bit patterns); ``x0``
    and ``x1`` broadcast against each other and the key.  Returns the two
    output words as int64 tensors in [0, 2^32).
    """
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _key_tensor(key) -> torch.Tensor:
    k = torch.as_tensor(key)
    if k.shape != (2,) or k.dtype.is_floating_point:
        raise ValueError(f"a key is two integer words, got {tuple(k.shape)} "
                         f"{k.dtype}")
    return k.to(torch.int64) & _MASK


def _words(key, device):
    """(k0, k1) for a computation on ``device``: Python ints from a CPU
    key (no transfer), 0-dim tensors from a key already there."""
    k = _key_tensor(key)
    if k.device.type == "cpu":
        return tuple(k.tolist())
    if k.device != torch.device(device):
        raise ValueError(f"key on {k.device}, draw on {device}")
    return k[0], k[1]


def _device(key, device):
    return torch.as_tensor(key).device if device is None \
        else torch.device(device)


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: the words
    [0, seed mod 2^32]."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not an int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def _counters(shape, device, start: int = 0):
    n = math.prod(shape)
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return (i >> 32), (i & _MASK)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) words on the key's device
    (a CPU key is split in Python integers)."""
    k = _key_tensor(key)
    if k.device.type == "cpu":
        words = tuple(k.tolist())
        return torch.tensor([threefry2x32(words, 0, j) for j in range(num)],
                            dtype=torch.int64).reshape(num, 2)
    b0, b1 = threefry2x32((k[0], k[1]), *_counters((num,), k.device))
    return torch.stack([b0, b1], dim=1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: an int, or
    a 0-dim tensor on the key's device."""
    k = _key_tensor(key)
    if k.device.type == "cpu" and not torch.is_tensor(data):
        return torch.tensor(threefry2x32(tuple(k.tolist()), 0,
                                         int(data) & _MASK),
                            dtype=torch.int64)
    d = torch.as_tensor(data).to(device=k.device, dtype=torch.int64) & _MASK
    b0, b1 = threefry2x32((k[0], k[1]), torch.zeros_like(d), d)
    return torch.stack([b0, b1])


def random_bits(key, shape, device=None, *, start: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): int64 tensor of the uint32
    patterns.  ``start``: the flat elements start .. start + prod(shape) - 1
    of a larger draw from the same key (a large draw made in pieces)."""
    dev = _device(key, device)
    b0, b1 = threefry2x32(_words(key, dev), *_counters(shape, dev, start))
    return (b0 ^ b1).reshape(shape)


def _as_float32(bits: torch.Tensor) -> torch.Tensor:
    i32 = (bits - ((bits >> 31) << 32)).to(torch.int32)
    return i32.view(torch.float32)


def uniform(key, shape=(), minval=0.0, maxval=1.0,
            device=None, *, start: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled to [minval, maxval).  ``start``
    as for ``random_bits``."""
    bits = random_bits(key, shape, device, start=start)
    floats = _as_float32((bits >> 9) | 0x3F800000) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return (floats * float(hi - lo) + float(lo)).clamp_min(float(lo))


def bernoulli(key, p) -> torch.Tensor:
    """``jax.random.bernoulli(key, p)``: ``uniform(key, p.shape) < p`` for
    a float32 tensor ``p``, drawn on ``p``'s device."""
    p = torch.as_tensor(p, dtype=torch.float32)
    return uniform(key, tuple(p.shape), device=p.device) < p


def randint(key, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32.

    JAX splits the key in two, draws 32 "higher" and 32 "lower" bits per
    element and reduces them mod the span with uint32 arithmetic that
    wraps: ``multiplier = ((2^16 mod span)^2 mod 2^32) mod span`` is 0 for
    any span above 2^16, and ``(hi mod span) * multiplier + (lo mod
    span)`` wraps mod 2^32 before the last ``mod span``.  Both wraps are
    kept.  ``maxval <= minval`` gives ``minval``.
    """
    for v in (minval, maxval):
        if not -2 ** 31 <= v < 2 ** 31:
            raise ValueError(f"randint bounds must be int32, got {v}")
    dev = _device(key, device)
    halves = split(key, 2)
    # both halves in one threefry call: half h's key words broadcast over
    # row h of the (2, n) counters
    if halves.device.type == "cpu":
        (a0, a1), (b0, b1) = halves.tolist()
        h = torch.arange(2, dtype=torch.int64, device=dev)[:, None]
        k0, k1 = a0 + h * (b0 - a0), a1 + h * (b1 - a1)
    else:
        k0, k1 = halves[:, 0:1], halves[:, 1:2]
    hi_c, lo_c = _counters(shape, dev)
    w0, w1 = threefry2x32((k0, k1), hi_c[None, :], lo_c[None, :])
    higher, lower = w0 ^ w1
    span = 1 if maxval <= minval else (maxval - minval) & _MASK
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span
    off = (((higher % span) * mult + (lower % span)) & _MASK) % span
    out = (minval + off) & _MASK
    return (out - ((out >> 31) << 32)).to(torch.int32).reshape(shape)


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"):
# coefficients for w = -log1p(-x^2) < 5 and >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, term for term (see the module
    docstring for how close it comes)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(key, shape=(), device=None, *, start: int = 0) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with
    ``u`` uniform in (nextafter(-1, 0), 1); within 4 ulps of JAX.
    ``start`` as for ``random_bits``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, float(lo), 1.0, device, start=start)
    return erf_inv(u) * float(np.float32(np.sqrt(2.0)))
