"""Plain PyTorch versions of the squared-distance kernels (B1, B6)."""
from __future__ import annotations

import torch


def pairwise_sqdist_ref(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, M), (B, C, M) -> (B, C) f32 ``||q[b] - c[b, j]||^2``."""
    diff = q.float()[:, None, :] - c.float()
    return (diff * diff).sum(dim=-1)


def pairwise_sqdist_gather_ref(x: torch.Tensor, qid: torch.Tensor,
                               cand: torch.Tensor) -> torch.Tensor:
    """(N, M), (B,), (B, C) -> (B, C) f32 ``||x[qid[b]] - x[cand[b, j]]||^2``.

    Indices are clipped to [0, N); invalid slots are the caller's concern.
    """
    n = x.shape[0]
    return pairwise_sqdist_ref(x[qid.long().clamp(0, n - 1)],
                               x[cand.long().clamp(0, n - 1)])
