"""The paper's flagship property on the port: change any hyperparameter
mid-run -- the HD-side perplexity included -- in one continual
optimisation (the counterpart of ``examples/interactive_hparams.py``).

A scripted stand-in for the GUI: 1,500 MNIST-like rows in 48 dimensions;
early exaggeration, then alpha 1.0 -> 0.5 (cluster fragmentation), 3x
repulsion (paper Sec. 4.1), and perplexity 15 -> 40 mid-flight, which the
sigma refresh absorbs within a few steps because the affinities are
re-derived from the live KNN sets.  Every hyperparameter is a 0-d tensor
on the run's device, passed to one step function (``make_step``): a
change is a new value, not a new kernel.

  python -m repro_torch.examples.interactive_hparams [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import funcsne
from repro_torch.core.dbscan import dbscan, relabel_compact
from repro_torch.data.synthetic import mnist_like
from repro_torch.kernels import _build

ITERS = (300, 250, 250, 250, 250)


def cluster_count(Y, q=0.02):
    """DBSCAN clusters of Y (min_pts 5) at eps = the ``q`` quantile of the
    nonzero distances among every (n // 1024)-th row."""
    Yn = Y.detach().cpu().numpy()
    sub = Yn[::max(1, len(Yn) // 1024)]
    d = np.sqrt(((sub[:, None] - sub[None, :]) ** 2).sum(-1))
    eps = float(np.quantile(d[d > 0], q))
    _, k = relabel_compact(dbscan(Y, eps, 5))
    return k


def phases(hp, iters=ITERS):
    """(name, steps, hparams) of the five phases, from ``hp`` at
    perplexity 15."""
    dev = hp.lr.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    return [
        ("warmup (early exaggeration)", iters[0],
         hp._replace(exaggeration=f32(12.0), momentum=f32(0.5))),
        ("alpha=1.0 (t-SNE tails)", iters[1], hp),
        ("alpha=0.5 (heavier tails)", iters[2],
         hp._replace(alpha=f32(0.5), lr=hp.lr * 0.3)),
        ("alpha=0.5 + 3x repulsion (de-collapse)", iters[3],
         hp._replace(alpha=f32(0.5), repulsion=f32(3.0), lr=hp.lr * 0.3)),
        ("perplexity 15 -> 40 (HD-side change!)", iters[4],
         hp._replace(perplexity=f32(40.0), lr=hp.lr * 0.3)),
    ]


def run_phases(st, X, cfg, plan, log=print):
    """Run each (name, steps, hparams) of ``plan`` through one
    ``make_step(cfg)``; returns ``(state, report)``, a dict a phase
    (``name``, ``iters``, ``seconds``, ``it_s``, ``clusters``) and the
    kernel library builds after the first phase."""
    step = funcsne.make_step(cfg)
    report, builds0 = [], None
    for name, iters, ph in plan:
        t0 = time.perf_counter()
        for _ in range(iters):
            st = step(st, X, ph)
        if st.Y.is_cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k = cluster_count(st.Y)
        report.append({"name": name, "iters": iters, "seconds": dt,
                       "it_s": iters / dt, "clusters": k})
        log(f"{name:45s} {iters} iters in {dt:5.1f}s "
            f"({iters / dt:5.0f} it/s)  clusters={k}")
        if builds0 is None:
            builds0 = _build.BUILDS
    builds = _build.BUILDS - builds0
    log(f"every hyperparameter above is a 0-d tensor on {st.Y.device.type} "
        f"passed to the same step; kernel library builds after the first "
        f"phase: {builds}")
    return st, report, builds


def run(n=1500, dim=48, iters=ITERS, log=print, device="cuda"):
    """The session at the reference's sizes; returns ``run_phases``'s."""
    dev = funcsne.resolve_device(device)
    X, _ = mnist_like(n=n, dim=dim, seed=0)
    X = torch.as_tensor(X, device=dev)
    cfg = funcsne.FuncSNEConfig(n_points=n, dim_hd=dim)
    st = funcsne.init_state(X, cfg, seed=0, device=dev)
    hp = funcsne.default_hparams(n, perplexity=15.0, device=dev)
    return run_phases(st, X, cfg, phases(hp, iters), log=log)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
