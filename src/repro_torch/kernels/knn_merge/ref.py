"""Plain PyTorch versions of the merge kernels (B4 and B2).

``merge_select`` is the kernels' selection algorithm written as flat
tensor code (the counterpart of ``repro.kernels.knn_merge.kernel.
merge_select``): dedup, then stable ranks over the [current, candidate]
concatenation.  ``knn_merge_ref`` (B4) scores a precomputed candidate
block and feeds it to ``merge_select``; ``knn_merge_cand_ref`` (B2)
generates the counter-RNG block of ``core.knn.counter_candidates`` first.
"""
from __future__ import annotations

import torch

from repro_torch.core.knn import SENTINEL, counter_candidates
from repro_torch.kernels.pairwise_sqdist.ref import pairwise_sqdist_gather_ref


def merge_select(qid_col, cur_idx, cur_d, cand, cand_d, ext_valid):
    """Dedup + stable-rank top-K merge of one row block.

    Equals ``knn.dedup_candidates`` followed by ``knn.merge_knn``:
    rank(e) = #{e' : d[e'] < d[e] or (d[e'] == d[e] and e' before e)} over
    the concatenation [cur, cand], and rank-k elements land in slot k.
    Returns (new_idx (B, K) int32, new_d (B, K) f32, improved (B,) bool).
    """
    b, k = cur_idx.shape
    c = cand.shape[1]
    dev = cand.device
    self_dup = cand == qid_col
    in_cur = (cand[:, :, None] == cur_idx[:, None, :]).any(dim=-1)
    ci = torch.arange(c, device=dev)[:, None]
    cj = torch.arange(c, device=dev)[None, :]
    within = ((cand[:, :, None] == cand[:, None, :]) & (cj < ci)).any(dim=-1)
    valid = ext_valid & ~(self_dup | in_cur | within | (cand == SENTINEL))
    cand_d = torch.where(valid, cand_d, torch.inf)
    improved = (cand_d < cur_d[:, k - 1:k]).any(dim=-1)

    all_d = torch.cat([cur_d, cand_d], dim=1)             # (B, K + C)
    all_idx = torch.cat([cur_idx, cand.to(cur_idx.dtype)], dim=1)
    e = torch.arange(k + c, device=dev)
    before = e[None, :] < e[:, None]                      # [e, e'] = e' < e
    de, dp = all_d[:, :, None], all_d[:, None, :]
    rank = ((dp < de) | ((dp == de) & before[None])).sum(dim=-1)
    # ranks are a permutation of 0..K+C-1: scatter each element to its slot
    new_idx = torch.empty_like(all_idx).scatter_(1, rank, all_idx)
    new_d = torch.empty_like(all_d).scatter_(1, rank, all_d)
    return new_idx[:, :k].contiguous(), new_d[:, :k].contiguous(), improved


def knn_merge_ref(x, qid, cur_idx, cur_d, cand, *, cand_active=None,
                  cur_valid=None):
    """Score a precomputed candidate block, dedup and merge (B4's plain
    version; see ``ops.knn_merge``).

    Candidates are scored at their clipped ids and merged as their raw
    ids; with ``cur_d=None`` the current rows are re-scored and masked by
    ``cur_valid``.  Equals the JAX ``knn_merge_ref`` and
    ``knn_merge_rank_ref``.
    """
    if cur_d is None:
        # rescore: the embedding moved since the list was merged
        k = cur_idx.shape[1]
        both = pairwise_sqdist_gather_ref(x, qid, torch.cat([cur_idx, cand], 1))
        cur_d, cand_d = both[:, :k], both[:, k:]
        cur_d = torch.where(cur_valid, cur_d, torch.inf)
    else:
        cand_d = pairwise_sqdist_gather_ref(x, qid, cand)
    if cand_active is None:
        cand_active = torch.ones(cand.shape, dtype=torch.bool,
                                 device=cand.device)
    return merge_select(qid[:, None], cur_idx, cur_d, cand, cand_d,
                        cand_active)


def knn_merge_cand_ref(x, qid, cur_idx, cur_d, *, salt, sources,
                       first_tables=(), second_tables=(), extra=None,
                       active=None, cur_valid=None):
    """Generate, score, dedup and merge (see ``ops.knn_merge_cand``)."""
    n = x.shape[0]
    cand = counter_candidates(salt, qid, sources, first_tables,
                              second_tables, n_total=n, extra=extra)
    cand_active = None if active is None \
        else active[cand.long().clamp(0, n - 1)]
    return knn_merge_ref(x, qid, cur_idx, cur_d, cand,
                         cand_active=cand_active, cur_valid=cur_valid)
