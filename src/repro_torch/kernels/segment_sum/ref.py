"""Plain PyTorch version of the deterministic segment sum."""
from __future__ import annotations

import torch


def segment_sum_ref(idx: torch.Tensor, val: torch.Tensor, n: int) -> torch.Tensor:
    """(E,) ids in [0, n), (E, d) f32 -> (n, d) f32 row sums.

    On the CPU ``index_add_`` adds in increasing e, which the kernel
    reproduces bit for bit; on the card it adds with float atomics (not
    repeatable in the last bits), so it is the plain version only.
    """
    out = torch.zeros((n, val.shape[1]), dtype=torch.float32,
                      device=val.device)
    return out.index_add_(0, idx.long(), val.float())
