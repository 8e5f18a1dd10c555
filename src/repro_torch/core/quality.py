"""Embedding quality: R_NX(K) and its AUC (port of ``repro.core.quality``).

R_NX(K) (Lee et al. 2015) rescales the K-ary neighbourhood agreement
Q_NX(K) = (1/NK) sum_i |est_i[:K] & true_i[:K]| so that 0 = random and
1 = perfect: R_NX(K) = ((N-1) Q_NX(K) - K) / (N - 1 - K).  The AUC weighs
scale K by 1/K.
"""
from __future__ import annotations

import torch

from repro_torch.core.knn import exact_knn


def _rank_in_true(est_idx, true_idx):
    """Position of each estimated neighbour inside the true order (or a
    value past every K when absent)."""
    match = est_idx[:, :, None] == true_idx[:, None, :]     # (N, Ke, Kt)
    pos = match.int().argmax(dim=-1)
    return torch.where(match.any(dim=-1), pos, 2 ** 31 - 1)


def qnx_curve(est_idx, true_idx):
    """Q_NX(K) for K = 1..Kmax, Kmax = min(est K, true K)."""
    kmax = min(est_idx.shape[1], true_idx.shape[1])
    est_idx, true_idx = est_idx[:, :kmax], true_idx[:, :kmax]
    n = est_idx.shape[0]
    rank = _rank_in_true(est_idx, true_idx)
    a = torch.arange(kmax, device=est_idx.device)[None, :]
    m = torch.maximum(a, rank)                      # joins at K = m + 1
    m = torch.where(m < kmax, m, kmax)              # the kmax bin = never
    hist = torch.zeros((kmax + 1,), device=est_idx.device).index_add_(
        0, m.reshape(-1), torch.ones(m.numel(), device=est_idx.device))
    overlap = torch.cumsum(hist, dim=0)[:kmax]
    ks = torch.arange(1, kmax + 1, device=est_idx.device)
    return overlap / (n * ks)


def rnx_curve(est_idx, true_idx, n_total=None):
    if n_total is None:
        n_total = est_idx.shape[0]
    q = qnx_curve(est_idx, true_idx)
    ks = torch.arange(1, q.shape[0] + 1, device=q.device)
    return ((n_total - 1) * q - ks) / (n_total - 1 - ks).clamp_min(1)


def rnx_auc(rnx):
    """1/K-weighted AUC of an R_NX curve."""
    w = 1.0 / torch.arange(1, rnx.shape[0] + 1, dtype=torch.float32,
                           device=rnx.device)
    return (rnx * w).sum() / w.sum()


def knn_set_quality(est_idx, X, kmax: int = None):
    """AUC of R_NX comparing estimated HD KNN sets to the exact sets."""
    k = est_idx.shape[1] if kmax is None else kmax
    true_idx, _ = exact_knn(X, k)
    return rnx_auc(rnx_curve(est_idx[:, :k], true_idx, X.shape[0]))


def embedding_quality(X, Y, kmax: int = 64):
    """AUC of R_NX comparing LD neighbourhoods to HD neighbourhoods."""
    kmax = min(kmax, X.shape[0] - 2)
    true_idx, _ = exact_knn(X, kmax)
    emb_idx, _ = exact_knn(Y, kmax)
    return rnx_auc(rnx_curve(emb_idx, true_idx, X.shape[0]))
