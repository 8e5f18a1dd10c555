"""Embedding quality: R_NX(K) and its AUC (port of ``repro.core.quality``).

R_NX(K) (Lee et al. 2015) rescales the K-ary neighbourhood agreement
Q_NX(K) = (1/NK) sum_i |est_i[:K] & true_i[:K]| so that 0 = random and
1 = perfect: R_NX(K) = ((N-1) Q_NX(K) - K) / (N - 1 - K).  The AUC weighs
scale K by 1/K.
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry
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


def _xla_mean(x):
    """``jnp.mean`` as XLA computes it: the float32 sum times
    float32(1 / count), not a division."""
    inv = torch.tensor(1.0 / x.numel(), dtype=torch.float32, device=x.device)
    return x.float().sum() * inv


def one_shot_prototypes(labels, classes, key):
    """One revealed example per class: member ``randint(fold_in(key, c),
    (), 0, count)`` of class ``c``'s members in index order (the draw of
    the JAX ``one_nn_accuracy``).  Returns (n_classes,) int64 row ids."""
    protos = []
    for ci in range(classes.shape[0]):
        members = torch.nonzero(labels == classes[ci])[:, 0]
        count = int(members.shape[0])
        pick = int(threefry.randint(threefry.fold_in(key, ci), (), 0,
                                    max(count, 1)))
        protos.append(int(members[pick]))
    return torch.tensor(protos, dtype=torch.int64, device=labels.device)


def one_nn_accuracy(Z, labels, key, n_trials: int = 1, one_shot: bool = False):
    """1-NN classification accuracy in representation Z (paper Table 2).

    one_shot: reveal one random labelled example per class per trial
    (``one_shot_prototypes`` with ``fold_in(key, t)``) and classify the
    rest by the nearest revealed example; otherwise leave-one-out 1-NN.
    ``key`` is a threefry key.  Returns a 0-dim float32 tensor.
    """
    Z = torch.as_tensor(Z).float()
    labels = torch.as_tensor(labels).to(Z.device)
    n = Z.shape[0]
    if not one_shot:
        idx, _ = exact_knn(Z, 1)
        return _xla_mean(labels[idx[:, 0].long()] == labels)

    classes = torch.unique(labels)
    accs = []
    for t in range(n_trials):
        protos = one_shot_prototypes(labels, classes, threefry.fold_in(key, t))
        d2 = ((Z[:, None, :] - Z[protos][None, :, :]) ** 2).sum(dim=-1)
        pred = classes[torch.argmin(d2, dim=1)]
        mask = ~torch.isin(torch.arange(n, device=Z.device), protos)
        accs.append(((pred == labels) & mask).sum() / mask.sum())
    return _xla_mean(torch.stack(accs))
