"""Variable-tail LD similarity kernel (paper Eq. 4) and exact losses (port
of ``repro.core.ld_kernels``).

w_ij = (1 + ||y_i - y_j||^2 / alpha)^(-alpha),   alpha in (0, inf)
  alpha = 1   -> Student-t with 1 dof (t-SNE)
  alpha < 1   -> heavier tails (finer cluster fragmentation)
  alpha -> inf -> Gaussian limit (SNE)

Closed forms:
  w^(1/alpha)     = (1 + d2/alpha)^(-1)
  w^(1+1/alpha)   = (1 + d2/alpha)^(-(alpha+1))

``alpha`` is taken as a float32 tensor on ``d2``'s device, as the JAX
functions take it as a float32 array.  The dense functions hold (N, N)
arrays: exact baselines and small N only.
"""
from __future__ import annotations

import torch


def _alpha(alpha, like):
    return torch.as_tensor(alpha, dtype=torch.float32).to(like.device)


def w_tail(d2, alpha):
    """Unnormalised LD similarity w(d2; alpha)."""
    alpha = _alpha(alpha, d2)
    return torch.exp(-alpha * torch.log1p(d2 / alpha))


def w_pow_inv_alpha(d2, alpha):
    """w^(1/alpha) = 1 / (1 + d2/alpha)."""
    alpha = _alpha(alpha, d2)
    return 1.0 / (1.0 + d2 / alpha)


def w_pow_one_plus_inv_alpha(d2, alpha):
    """w^(1+1/alpha) = (1 + d2/alpha)^(-(alpha+1))."""
    alpha = _alpha(alpha, d2)
    return torch.exp(-(alpha + 1.0) * torch.log1p(d2 / alpha))


def pairwise_sqdists_full(Y):
    """Dense (N, N) squared distances."""
    n2 = (Y * Y).sum(dim=1)
    d2 = n2[:, None] + n2[None, :] - 2.0 * (Y @ Y.T)
    # maximum, not clamp: its gradient splits ties as jnp.maximum's does
    return torch.maximum(d2, torch.zeros((), dtype=d2.dtype, device=d2.device))


def q_matrix(Y, alpha):
    """Dense normalised LD similarities q_ij (Eq. 4); q_ii = 0.  Returns
    (q, w)."""
    d2 = pairwise_sqdists_full(Y)
    w = w_tail(d2, alpha)
    w = w * (1.0 - torch.eye(Y.shape[0], dtype=w.dtype, device=w.device))
    return w / w.sum(), w


def kl_loss(P, Y, alpha, eps: float = 1e-12):
    """Exact KL(P || Q) with the variable-tail kernel (validation oracle)."""
    q, _ = q_matrix(Y, alpha)
    mask = P > 0
    eps_t = torch.tensor(eps, dtype=q.dtype, device=q.device)
    ratio = torch.where(mask, P / torch.maximum(q, eps_t), 1.0)
    return torch.where(mask, P * torch.log(ratio), 0.0).sum()
