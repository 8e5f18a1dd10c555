"""Quickstart on the port: embed a synthetic single-cell-style dataset
with FUnc-SNE (the counterpart of ``examples/quickstart.py``).

  python -m repro_torch.examples.quickstart [--device cpu]

2,000 cells in 32 dimensions (4 major types of 4 sub-types), 750 steps
of ``fit`` at perplexity 15; prints the HD KNN quality, the embedding's
R_NX AUC and the 1-NN major-type accuracy in 2-D, and writes the
embedding to ``quickstart_embedding.npy`` in the working directory.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import funcsne, threefry
from repro_torch.core.quality import (embedding_quality, knn_set_quality,
                                      one_nn_accuracy)
from repro_torch.data.synthetic import hierarchical_cells

OUT = "quickstart_embedding.npy"


def run(n=2000, dim=32, n_iter=750, perplexity=15.0, out=OUT, log=print,
        device="cuda"):
    """Embed ``hierarchical_cells(n, dim, seed=0)``; returns the three
    qualities as a dict (``hd_knn``, ``embedding``, ``one_nn``)."""
    dev = funcsne.resolve_device(device)
    X, major, _ = hierarchical_cells(n=n, dim=dim, seed=0)
    hp = funcsne.default_hparams(len(X), alpha=1.0, perplexity=perplexity,
                                 device=dev)
    st, _ = funcsne.fit(X, n_iter=n_iter, hparams=hp, device=dev)

    Xt = torch.as_tensor(X, device=dev)
    q = {"hd_knn": float(knn_set_quality(st.hd_idx, Xt)),
         "embedding": float(embedding_quality(Xt, st.Y)),
         "one_nn": float(one_nn_accuracy(st.Y, torch.as_tensor(
             major, device=dev), threefry.prng_key(0)))}
    log(f"HD KNN quality (AUC R_NX vs exact): {q['hd_knn']:.3f}")
    log(f"embedding quality (AUC R_NX):        {q['embedding']:.3f}")
    log(f"1-NN major-type accuracy in 2-D:     {q['one_nn']:.3f}")
    np.save(out, st.Y.cpu().numpy())
    log(f"wrote {out}")
    return q


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
