"""Plain PyTorch versions of the force kernels: pre-gathered (B7),
index-taking with per-edge output (B5) and scatter-fused (B3).

Variable-tail LD kernel (paper Eq. 4): w(d2) = (1 + d2/alpha)^(-alpha), with
  attraction: edge = coef * w^(1/alpha) * (nbr - y),      wsum = sum coef * w^(1/alpha)
  repulsion:  edge = coef * w^(1+1/alpha) * (y - nbr),    wsum = sum coef * w
B7 and B5 return each row's sum of edges (agg), the edges themselves and
the wsums.  B3 bins each segment's edges into an (N, d) field: the query
row gets the sum of its edges, and where the segment scatters back each
neighbour row gets the edge's reaction (-edge).
"""
from __future__ import annotations

import torch


def ne_forces_ref(y, nbr, coef, alpha, *, mode: str):
    """(B, d), (B, K, d), (B, K), alpha -> (agg (B, d), edge (B, K, d),
    wsum (B,)), as ``repro.kernels.ne_forces.ref.ne_forces_ref``."""
    delta = nbr - y[:, None, :]
    d2 = (delta * delta).sum(dim=-1)
    base = 1.0 + d2 / alpha
    if mode == "attraction":
        wexp = 1.0 / base
        edge = (coef * wexp)[..., None] * delta
        wsum = (coef * wexp).sum(dim=-1)
    elif mode == "repulsion":
        wexp = torch.exp(-(alpha + 1.0) * torch.log(base))
        w = torch.exp(-alpha * torch.log(base))
        edge = (coef * wexp)[..., None] * (-delta)
        wsum = (coef * w).sum(dim=-1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return edge.sum(dim=1), edge, wsum


def ne_forces_gather_ref(x, qid, nbr_idx, coef, alpha, *, segments,
                         emit_edges):
    """Per-segment (aggs, edges, wsums) from indices, as
    ``repro.kernels.ne_forces.ref.ne_forces_gather_ref``: ``edges[s]`` is
    None where ``emit_edges[s]`` is False; ids are clipped to [0, N)."""
    n = x.shape[0]
    y = x[qid.long().clamp(0, n - 1)]
    aggs, edges, wsums = [], [], []
    k0 = 0
    for (mode, size), emit in zip(segments, emit_edges):
        tgt = nbr_idx[:, k0:k0 + size].long().clamp(0, n - 1)
        agg, edge, wsum = ne_forces_ref(y, x[tgt], coef[:, k0:k0 + size],
                                        alpha, mode=mode)
        aggs.append(agg)
        edges.append(edge if emit else None)
        wsums.append(wsum)
        k0 += size
    return tuple(aggs), tuple(edges), tuple(wsums)


def ne_forces_scatter_ref(x, qid, nbr_idx, coef, alpha, *, segments,
                          scatter_back=None):
    """Per-segment (N, d) fields and (B,) wsums (see the module doc)."""
    if scatter_back is None:
        scatter_back = (True,) * len(segments)
    n, d = x.shape
    qc = qid.long().clamp(0, n - 1)
    y = x[qc]
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    scats, wsums = [], []
    k0 = 0
    for (mode, size), back in zip(segments, scatter_back):
        tgt = nbr_idx[:, k0:k0 + size].long().clamp(0, n - 1)
        agg, edge, wsum = ne_forces_ref(y, x[tgt], coef[:, k0:k0 + size],
                                        alpha, mode=mode)
        scat = torch.zeros((n, d), dtype=torch.float32,
                           device=x.device).index_add_(0, qc, agg)
        if back:
            scat = scat + torch.zeros_like(scat).index_add_(
                0, tgt.reshape(-1), -edge.reshape(-1, d))
        scats.append(scat)
        wsums.append(wsum)
        k0 += size
    return tuple(scats), tuple(wsums)
