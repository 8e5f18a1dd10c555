"""Hierarchical cluster-graph extraction via an alpha sweep (paper Sec. 4.2;
port of ``repro.core.hierarchy``).

A continual FUnc-SNE optimisation is run while the LD kernel tails slowly
get heavier (alpha decreases level by level).  Snapshots Y^(l) are clustered
with DBSCAN; clusters become nodes and consecutive-level nodes are linked by

    e_ij = |C_i^(g) cap C_j^(h)| / min(|C_i|, |C_j|)   if |h - g| = 1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import funcsne
from repro_torch.core.dbscan import dbscan, relabel_compact


@dataclasses.dataclass
class HierarchyLevel:
    alpha: float
    labels: np.ndarray          # (N,) cluster id per point, -1 = noise
    n_clusters: int
    sizes: List[int]


@dataclasses.dataclass
class ClusterGraph:
    levels: List[HierarchyLevel]
    edges: List[tuple]          # (level_g, i, level_h=g+1, j, weight)

    def summary(self) -> str:
        lines = []
        for li, lv in enumerate(self.levels):
            lines.append(f"level {li}: alpha={lv.alpha:.3f} "
                         f"clusters={lv.n_clusters} sizes={lv.sizes[:12]}")
        lines.append(f"{len(self.edges)} inter-level edges")
        return "\n".join(lines)


def cluster_graph_edges(levels: List[HierarchyLevel], min_weight: float = 0.1):
    edges = []
    for g in range(len(levels) - 1):
        a, b = levels[g], levels[g + 1]
        for i in range(a.n_clusters):
            mi = a.labels == i
            for j in range(b.n_clusters):
                mj = b.labels == j
                inter = int(np.sum(mi & mj))
                denom = min(int(np.sum(mi)), int(np.sum(mj)))
                if denom and inter / denom >= min_weight:
                    edges.append((g, i, g + 1, j, inter / denom))
    return edges


def select_eps(Y, quantile: float, *, max_rows: int = 1024,
               seed: int = 0) -> float:
    """DBSCAN ``eps`` = the ``quantile`` of pairwise snapshot distances,
    over a seeded subsample of at most ``max_rows`` rows (numpy)."""
    Y = np.asarray(Y)
    n = Y.shape[0]
    m = min(n, int(max_rows))
    idx = np.random.default_rng(seed).choice(n, size=m, replace=False)
    d = np.sqrt(((Y[idx, None, :] - Y[None, idx, :]) ** 2).sum(-1))
    pos = d[d > 0]
    if pos.size == 0:
        # a fully collapsed snapshot has no distance scale: eps 0 makes
        # DBSCAN cluster exact duplicates
        return 0.0
    return float(np.quantile(pos, quantile))


def extract_hierarchy(X, alphas, *, cfg: Optional[funcsne.FuncSNEConfig] = None,
                      iters_per_level: int = 300, warmup_iters: int = 300,
                      eps_quantile: float = 0.02, min_pts: int = 5,
                      seed: int = 0, eps_sample_rows: int = 1024,
                      eps_seed: int = 0,
                      hparams: Optional[funcsne.HParams] = None,
                      dbscan_fn: Callable = dbscan,
                      chunk_size: int = 50, device="cuda") -> ClusterGraph:
    """Run the continual optimisation, snapshot per alpha level, and build
    the cluster graph.  ``alphas`` should decrease (heavier tails).

    The optimisation runs in chunks of ``chunk_size`` steps; the warmup
    evaluates the early-exaggeration schedule from the carried step, and
    the levels reuse one chunk runner per (T, scheduled, horizon) for
    every alpha.  ``dbscan_fn(Y, eps, min_pts)`` gets each level's
    snapshot as a tensor on the run's device.
    """
    dev = funcsne.resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
    n = X.shape[0]
    if cfg is None:
        cfg = funcsne.FuncSNEConfig(n_points=n, dim_hd=X.shape[1], dim_ld=4)
    if hparams is None:
        hparams = funcsne.default_hparams(n, device=dev)
    st = funcsne.init_state(X, cfg, seed=seed, device=dev)

    chunks = {}      # (T, scheduled, horizon) -> chunk runner

    def run_steps(st, n_steps, hp, schedule=None, horizon=None):
        it = 0
        while it < n_steps:
            T = min(chunk_size, n_steps - it)
            key = (T, schedule is not None, horizon)
            if key not in chunks:
                chunks[key] = funcsne.make_chunked_step(
                    cfg, T, schedule=schedule, n_iter=horizon)
            st, _, _ = chunks[key](st, X, hp)
            it += T
        return st

    def with_alpha(alpha):
        return hparams._replace(alpha=torch.tensor(
            alpha, dtype=torch.float32, device=dev))

    # warmup at the first alpha with early exaggeration: the schedule
    # reads the carried st.step, which starts at 0 here
    st = run_steps(st, warmup_iters, with_alpha(alphas[0]),
                   schedule=funcsne.default_schedule, horizon=warmup_iters)

    levels: List[HierarchyLevel] = []
    for alpha in alphas:
        st = run_steps(st, iters_per_level, with_alpha(alpha))
        eps = select_eps(st.Y.cpu().numpy(), eps_quantile,
                         max_rows=eps_sample_rows, seed=eps_seed)
        labels, k = relabel_compact(dbscan_fn(st.Y, eps, min_pts))
        sizes = [int(np.sum(labels == i)) for i in range(k)]
        levels.append(HierarchyLevel(float(alpha), labels, k, sizes))

    return ClusterGraph(levels, cluster_graph_edges(levels))
