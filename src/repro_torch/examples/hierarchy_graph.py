"""Paper Sec. 4.2 on the port: extract a cluster hierarchy by sweeping
alpha in one continual optimisation (d_ld = 4) and linking DBSCAN
clusters across levels (the counterpart of ``examples/hierarchy_graph.py``).

  python -m repro_torch.examples.hierarchy_graph [--device cpu]

1,200 cells in 24 dimensions (4 major types of 4 sub-types), alpha 3.0,
1.0, 0.5 with 300 warm-up steps and 300 steps a level; prints the graph,
the cluster counts per level and the strong parent -> child edges.
"""
from __future__ import annotations

import argparse

from repro_torch.core.hierarchy import extract_hierarchy
from repro_torch.data.synthetic import hierarchical_cells


def run(n=1200, dim=24, alphas=(3.0, 1.0, 0.5), iters_per_level=300,
        warmup_iters=300, log=print, device="cuda"):
    """Returns ``(graph, counts, strong)``: the ``ClusterGraph``, the
    cluster count of each level and the edges of overlap above 0.5."""
    X, _, _ = hierarchical_cells(n=n, dim=dim, n_major=4, minors_per_major=4,
                                 seed=0)
    graph = extract_hierarchy(X, alphas=alphas,
                              iters_per_level=iters_per_level,
                              warmup_iters=warmup_iters, device=device)
    log(graph.summary())
    # ground truth: 4 major types splitting into 16 minor types
    counts = [lv.n_clusters for lv in graph.levels]
    log(f"cluster counts per level (alpha {alphas[0]} -> {alphas[-1]}): "
        f"{counts}")
    log("(data truth: 4 major -> 16 minor)")
    strong = [e for e in graph.edges if e[4] > 0.5]
    log(f"{len(strong)} strong parent->child edges, e.g.:")
    for e in strong[:8]:
        log(f"  level{e[0]}/cluster{e[1]} -> level{e[2]}/cluster{e[3]} "
            f"(overlap {e[4]:.2f})")
    return graph, counts, strong


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
