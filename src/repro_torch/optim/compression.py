"""Gradient compression (port of ``repro.optim.compression``).

Top-k sparsification with error feedback (Deep Gradient Compression):
only the k largest-|g| entries of each leaf are kept; the residual is
carried into the next step, so the compression is unbiased over time.  The
compressed tensor is a masked dense tensor.  int8 gradient quantisation
with stochastic rounding, its noise drawn by ``core.threefry.uniform``
(``jax.random.uniform``'s bits), is also provided.

In the JAX package these feed the cross-pod (DCN) reduction, a ``psum``
over the pod axis across hosts; that collective is multi-host and out of
scope here (the port runs one host): the functions themselves are ported.
The port's leaves are per layer where the JAX package stacks its layers,
so on an LM tree each layer's leaf takes its own top-k.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import threefry
from repro_torch.optim.optimizers import tree_map


class EFState(NamedTuple):
    residual: Any          # same structure as grads


def init_ef(grads_shape) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_shape))


def topk_sparsify(g, k_frac: float):
    """Keep the k largest-magnitude entries; returns (sparse_dense, mask)."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.numel() * k_frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = flat.abs() >= thresh
    return (flat * mask).reshape(g.shape), mask.reshape(g.shape)


def compress_with_error_feedback(grads, ef: EFState, k_frac: float):
    """Returns (sparse grads to all-reduce, new EF state, mean density)."""
    dens = []

    def one(g, r):
        acc = g.float() + r
        sparse, mask = topk_sparsify(acc, k_frac)
        dens.append(mask.float().mean())
        return sparse, acc - sparse

    out = tree_map(one, grads, ef.residual)
    sparse = tree_map(lambda _, o: o[0], grads, out)
    new_ef = EFState(residual=tree_map(lambda _, o: o[1], grads, out))
    return sparse, new_ef, torch.stack(dens).mean()


def quantize_int8_stochastic(g, rng):
    """Stochastic-rounding int8 quantisation of a gradient tensor; ``rng``
    a threefry key."""
    g32 = g.float()
    absmax = torch.clamp(g32.abs().max(), min=1e-12)
    scale = absmax / 127.0
    scaled = g32 / scale
    noise = threefry.uniform(rng, tuple(g.shape), device=g.device) - 0.5
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale
