"""HD affinities: perplexity-calibrated per-point bandwidths (port of
``repro.core.affinities``).

p_{j|i} = exp(-beta_i * d2_ij) / sum_k exp(-beta_i * d2_ik), with beta_i
solved by vectorised bisection so that the row entropy equals
log(perplexity).  Every operation follows the JAX version in order, so the
two agree to float32 rounding; where an entropy lands within rounding of
the target the bisection may take the other branch on one side (see the
tolerance stated in tests/test_torch_knn.py).
"""
from __future__ import annotations

import math

import torch


def entropy_of_beta(d2, beta, valid):
    """Shannon entropy (nats) of the p_{.|i} row for bandwidth beta."""
    d2s = torch.where(valid, d2, torch.inf)
    dmin = d2s.amin(dim=-1, keepdim=True)
    dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)
    logits = -beta[..., None] * (d2s - dmin)
    logits = torch.where(valid, logits, -torch.inf)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(valid, torch.exp(logits - m), 0.0)
    z = e.sum(dim=-1)
    p = e / z[..., None].clamp_min(1e-30)
    plogp = torch.where(p > 0, p * torch.log(p.clamp_min(1e-30)), 0.0)
    return -plogp.sum(dim=-1)


def solve_beta(d2, perplexity, valid=None, beta0=None, n_iter: int = 40):
    """Vectorised bisection for beta_i s.t. H_i = log(perplexity).

    Entropy decreases in beta; the bracket [0, inf) expands by doubling
    while the upper bound is open.  ``beta0`` warm-starts the first probe.
    """
    if valid is None:
        valid = torch.isfinite(d2)
    target = torch.log(torch.as_tensor(perplexity, dtype=torch.float32,
                                       device=d2.device))
    n = d2.shape[0]
    beta = (torch.ones((n,), dtype=torch.float32, device=d2.device)
            if beta0 is None else beta0.to(torch.float32))
    lo = torch.zeros((n,), dtype=torch.float32, device=d2.device)
    hi = torch.full((n,), math.inf, dtype=torch.float32, device=d2.device)
    for _ in range(n_iter):
        h = entropy_of_beta(d2, beta, valid)
        too_flat = h > target          # entropy too high -> increase beta
        lo = torch.where(too_flat, beta, lo)
        hi = torch.where(too_flat, hi, beta)
        beta_up = torch.where(torch.isfinite(hi), 0.5 * (lo + hi), beta * 2.0)
        beta_dn = 0.5 * (lo + hi)
        beta = torch.where(too_flat, beta_up, beta_dn)
    return beta


def p_rows(d2, beta, valid=None):
    """Row-normalised p_{j|i} over the (estimated) KNN set."""
    if valid is None:
        valid = torch.isfinite(d2)
    d2s = torch.where(valid, d2, torch.inf)
    dmin = d2s.amin(dim=-1, keepdim=True)
    dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)
    e = torch.where(valid, torch.exp(-beta[:, None] * (d2s - dmin)), 0.0)
    z = e.sum(dim=-1, keepdim=True)
    return e / z.clamp_min(1e-30)
