"""DBSCAN (Ester et al., 1996) for the hierarchy extraction (port of
``repro.core.dbscan``).

The JAX function is dense: an (N, N) eps-adjacency and a bounded number
of min-label sweeps over it.  The port computes exactly the same labels
over blocks of ``BLOCK_ROWS`` query rows, so that no (N, N) array is ever
held: at N = 70,000 one (N, N) float32 array is 19.6 GB.  Each sweep and
the border pass recompute a block's squared distances with the JAX
formula (``|a|^2 + |b|^2 - 2 a.b``, clamped at 0).
"""
from __future__ import annotations

import math

import numpy as np
import torch

# query rows a block: (BLOCK_ROWS, N) float32 distances and int32 labels
# live at once (2.3 GB at N = 70,000)
BLOCK_ROWS = 4096


def max_sweeps_of(n: int) -> int:
    """The JAX default ``ceil(log2 n) + 2``, with log2 taken in float32 as
    ``jnp.log2`` takes it."""
    return int(math.ceil(float(np.log2(np.float32(n))))) + 2


def _blocks(n):
    for r0 in range(0, n, BLOCK_ROWS):
        yield r0, min(n, r0 + BLOCK_ROWS)


def dbscan(Y, eps: float, min_pts: int = 5, max_sweeps: int = 0):
    """Integer labels of the rows of ``Y`` (on its device), -1 = noise.

    Core points: >= min_pts neighbours within eps (inclusive of self).
    Clusters: min-label propagation over the core-core eps-graph for
    ``max_sweeps`` sweeps (default ``ceil(log2 N) + 2``), as in the JAX
    function: a chain of core points longer than that keeps several
    labels.  Border points adopt the label of their nearest core
    neighbour within eps (the first such on a tie).  Returns (N,) int32.
    """
    Y = torch.as_tensor(Y, dtype=torch.float32)
    n = Y.shape[0]
    dev = Y.device
    if max_sweeps <= 0:
        max_sweeps = max_sweeps_of(n)
    n2 = (Y * Y).sum(dim=1)
    thr = torch.tensor(np.float32(eps * eps), device=dev)
    cols = torch.arange(n, dtype=torch.int32, device=dev)

    def within(r0, r1):
        d2 = n2[r0:r1, None] + n2[None, :] - 2.0 * (Y[r0:r1] @ Y.T)
        d2 = d2.clamp_min(0.0)
        return d2, d2 <= thr

    core = torch.cat([w.sum(dim=1) >= min_pts
                      for _, w in (within(r0, r1) for r0, r1 in _blocks(n))])
    labels = torch.where(core, cols, n)         # n = unassigned
    for _ in range(max_sweeps):
        # every row from the previous sweep's labels (the dense sweep)
        new = torch.empty_like(labels)
        for r0, r1 in _blocks(n):
            _, w = within(r0, r1)
            adj = w & core[r0:r1, None] & core[None, :]
            neigh = torch.where(adj, labels[None, :], n).amin(dim=1)
            # the dense adjacency's diagonal holds core rows themselves
            new[r0:r1] = torch.minimum(labels[r0:r1], neigh)
        labels = new

    out = torch.empty_like(labels)
    for r0, r1 in _blocks(n):
        d2, w = within(r0, r1)
        near_core = w & core[None, :]
        d2_core = torch.where(near_core, d2, torch.inf)
        # argmin's first index among equal minima, written out
        best = d2_core.amin(dim=1, keepdim=True)
        nearest = torch.where(d2_core == best, cols[None, :], n).amin(dim=1)
        border = torch.where(near_core.any(dim=1),
                             labels[nearest.clamp_max(n - 1).long()], -1)
        out[r0:r1] = torch.where(core[r0:r1], labels[r0:r1], border)
    return torch.where(out == n, -1, out)


def relabel_compact(labels):
    """Map labels to 0..k-1 in increasing order (noise stays -1); returns
    (numpy int32 labels, k)."""
    lab = labels.cpu().numpy() if torch.is_tensor(labels) \
        else np.asarray(labels)
    uniq = np.unique(lab[lab >= 0])
    out = np.where(lab >= 0, np.searchsorted(uniq, lab), -1)
    return out.astype(np.int32), len(uniq)
