"""Baselines the paper compares against (port of ``repro.core.baselines``).

- ``exact_tsne``: O(N^2) gradient descent on the exact variable-tail KL
  (Eqs. 4-5), the quality oracle; ``exact_tsne_grad`` is the analytic
  gradient that FUnc-SNE's force decomposition approximates.
- ``negative_sampling_embed``: the UMAP/LargeVis regime inside the same
  force kernels -- exact KNN fixed once, attraction over HD neighbours,
  repulsion from uniform negative samples only (paper Table 1 row 1 vs
  row 3).  Each iteration launches B7 twice (attraction, repulsion) and
  adds the attraction's reactions with the deterministic segment sum.

Every draw comes from ``core.threefry``: ``seed`` stands for the JAX
functions' ``rng=PRNGKey(seed)``, so the negatives are the JAX package's
and the start is within ``normal``'s tolerance of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import affinities, knn, threefry
from repro_torch.core.funcsne import (KERNELS, HParams, Ops, default_hparams,
                                      default_schedule, resolve_device)
from repro_torch.core.ld_kernels import (kl_loss, pairwise_sqdists_full,
                                        w_pow_inv_alpha, w_tail)


def exact_p_matrix(X, perplexity: float):
    """Dense symmetrised p_ij from exact pairwise distances (Eq. 1)."""
    n = X.shape[0]
    d2 = pairwise_sqdists_full(X)
    d2 = torch.where(torch.eye(n, dtype=torch.bool, device=X.device),
                     torch.inf, d2)
    beta = affinities.solve_beta(d2, perplexity)
    p_cond = affinities.p_rows(d2, beta)
    return (p_cond + p_cond.T) / (2.0 * n)


def exact_tsne_grad(Y, P, alpha):
    """Analytic Eq. 5 gradient: 4 sum_j (p_ij - q_ij) w^(1/alpha) (y_i-y_j)."""
    n = Y.shape[0]
    d2 = pairwise_sqdists_full(Y)
    w = w_tail(d2, alpha) * (1.0 - torch.eye(n, dtype=Y.dtype,
                                             device=Y.device))
    q = w / w.sum()
    wi = w_pow_inv_alpha(d2, alpha)
    m = (P - q) * wi
    # grad_i = 4 [ y_i * sum_j m_ij - sum_j m_ij y_j ]
    return 4.0 * (Y * m.sum(dim=1, keepdim=True) - m @ Y)


def exact_tsne(X=None, P=None, *, dim_ld: int = 2, alpha: float = 1.0,
               perplexity: float = 30.0, n_iter: int = 500, seed: int = 0,
               lr: float = None, use_autodiff: bool = False, Y0=None,
               device="cuda"):
    """Exact (quadratic) variable-tail t-SNE with gains and momentum.

    Exaggeration 12 for the first quarter multiplies P in the analytic
    gradient.  ``use_autodiff=True`` takes ``torch.autograd``'s gradient of
    :func:`kl_loss` instead, and, as the JAX function does, without the
    exaggeration.
    """
    dev = resolve_device(device)
    if P is None:
        P = exact_p_matrix(torch.as_tensor(X, dtype=torch.float32).to(dev),
                           perplexity)
    P = torch.as_tensor(P, dtype=torch.float32).to(dev)
    n = P.shape[0]
    if lr is None:
        lr = max(50.0, n / 12.0)
    Y = (threefry.normal(threefry.prng_key(seed), (n, dim_ld), device=dev)
         * 1e-2 if Y0 is None
         else torch.as_tensor(Y0, dtype=torch.float32).to(dev))
    vel = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    alpha = torch.tensor(alpha, dtype=torch.float32, device=dev)

    def grad(Y, ex):
        if not use_autodiff:
            return exact_tsne_grad(Y, P * ex, alpha)
        y = Y.detach().requires_grad_(True)
        return torch.autograd.grad(kl_loss(P, y, alpha), y)[0]

    for it in range(n_iter):
        ex = 12.0 if it < n_iter // 4 else 1.0
        dY = -grad(Y, ex)
        same = torch.sign(dY) == torch.sign(vel)
        gains = torch.where(same, gains + 0.2, gains * 0.8).clamp_min(0.01)
        vel = 0.8 * vel + lr * gains * dY
        Y = Y + vel
    return Y


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Negative-sampling-only (UMAP-regime) embedding config."""
    k_hd: int = 32
    n_negatives: int = 8


class NSState(NamedTuple):
    Y: Any          # (N, d) f32
    vel: Any        # (N, d) f32
    gains: Any      # (N, d) f32
    zhat: Any       # () f32 EMA'd Z estimate


class NSProblem(NamedTuple):
    """What phase 1 fixes: the exact HD lists and their p_{j|i}, and the
    key the iterations' negatives are drawn from."""
    idx: Any        # (N, k_hd) int32
    p: Any          # (N, k_hd) f32
    key: Any        # threefry key of the iterations


def ns_init(X, cfg: NSConfig, *, dim_ld: int, hparams: HParams,
            seed: int):
    """Phase 1 (exact KNN, perplexity calibration) and the start: returns
    (NSProblem, NSState) on ``X``'s device."""
    n = X.shape[0]
    r_y, r_it = threefry.split(threefry.prng_key(seed))
    idx, d2 = knn.exact_knn(X, cfg.k_hd)
    beta = affinities.solve_beta(d2, hparams.perplexity)
    p = affinities.p_rows(d2, beta)
    Y = threefry.normal(r_y, (n, dim_ld), device=X.device) * 1e-2
    st = NSState(Y, torch.zeros_like(Y), torch.ones_like(Y),
                 torch.tensor(float(n), dtype=torch.float32, device=X.device))
    return NSProblem(idx, p, r_it), st


def ns_negatives(prob: NSProblem, it: int, n_negatives: int):
    """Iteration ``it``'s negatives: ``randint(fold_in(key, it), (N,
    n_negatives), 0, N)``, drawn on the lists' device."""
    n = prob.idx.shape[0]
    return threefry.randint(threefry.fold_in(prob.key, it), (n, n_negatives),
                            0, n, device=prob.idx.device)


def ns_step(cfg: NSConfig, prob: NSProblem, st: NSState, neg, hp: HParams,
            it: int, ops: Ops = KERNELS) -> NSState:
    """One iteration: attraction over the HD lists and repulsion from
    ``neg`` (B7 each), the Z estimate (its EMA starts at ``it == 0``), the
    attraction's reactions added by the segment sum, gains and momentum.
    ``ops`` selects the kernels (default) or the plain versions."""
    Y = st.Y
    n, d = Y.shape
    coef_a = prob.p / (2.0 * n)
    agg_a, edge_a, _ = ops.ne_forces(Y, Y[prob.idx.long()], coef_a, hp.alpha,
                                     mode="attraction")
    ones = torch.ones((n, cfg.n_negatives), dtype=torch.float32,
                      device=Y.device)
    agg_n, _, wsum_n = ops.ne_forces(Y, Y[neg.long()], ones, hp.alpha,
                                     mode="repulsion")
    scale = (n - 1.0) / cfg.n_negatives
    z_est = (scale * wsum_n.sum()).clamp_min(1e-8)
    zhat = z_est if it == 0 else 0.9 * st.zhat + 0.1 * z_est
    attr = hp.attraction * hp.exaggeration
    buf = attr * agg_a + hp.repulsion * scale / zhat * agg_n
    # each attraction edge's reaction on its neighbour row, added after
    # the row's own term in edge order (the JAX .at[idx].add)
    ids = torch.arange(n, dtype=torch.int32, device=Y.device)
    buf = ops.segment_sum(torch.cat([ids, prob.idx.reshape(-1)]),
                          torch.cat([buf, -(attr * edge_a).reshape(-1, d)]), n)
    dY = 4.0 * buf
    same = torch.sign(dY) == torch.sign(st.vel)
    gains = torch.where(same, st.gains + 0.2, st.gains * 0.8).clamp_min(0.01)
    vel = hp.momentum * st.vel + hp.lr * gains * dY
    return NSState(Y + vel, vel, gains, zhat)


def negative_sampling_embed(X, *, cfg: NSConfig = NSConfig(),
                            dim_ld: int = 2, n_iter: int = 750,
                            hparams: HParams = None, seed: int = 0,
                            device="cuda"):
    """Two-phase NS-only baseline (UMAP/LargeVis regime).

    Phase 1: exact KNN + perplexity calibration (fixed thereafter).
    Phase 2: attraction over the KNN graph, repulsion from uniform negative
    samples only, with ``default_schedule`` each iteration.  Returns Y.
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
    if hparams is None:
        hparams = default_hparams(X.shape[0], device=dev)
    prob, st = ns_init(X, cfg, dim_ld=dim_ld, hparams=hparams, seed=seed)
    for it in range(n_iter):
        hp = default_schedule(it, n_iter, hparams)
        st = ns_step(cfg, prob, st, ns_negatives(prob, it, cfg.n_negatives),
                     hp, it)
    return st.Y
