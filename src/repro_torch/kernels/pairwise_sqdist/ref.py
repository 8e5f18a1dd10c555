"""Plain PyTorch version of the gathered squared-distance kernel (B1)."""
from __future__ import annotations

import torch


def pairwise_sqdist_gather_ref(x: torch.Tensor, qid: torch.Tensor,
                               cand: torch.Tensor) -> torch.Tensor:
    """(N, M), (B,), (B, C) -> (B, C) f32 ``||x[qid[b]] - x[cand[b, j]]||^2``.

    Indices are clipped to [0, N); invalid slots are the caller's concern.
    """
    n = x.shape[0]
    q = x[qid.long().clamp(0, n - 1)].float()
    c = x[cand.long().clamp(0, n - 1)].float()
    diff = q[:, None, :] - c
    return (diff * diff).sum(dim=-1)
