"""End-to-end FUnc-SNE embedding launcher of the port (single device).

  PYTHONPATH=src python -m repro_torch.launch.embed --dataset mnist-like \
      --n 70000 --iters 500 --chunk 50

Runs ``init_state`` and the chunk runner with ``default_schedule`` on one
CUDA card (``--device cpu`` runs the plain versions on the CPU), prints
steps per second (a warm-up chunk on a copy of the state runs first, so
the kernels' build is not timed) and the R_NX AUC, and optionally writes
the embedding to ``.npy``.  ``mnist-like`` is the 64-wide stand-in of
``repro.launch.embed``; ``chip_smoke.py`` runs MNIST's 784-wide shape.

``--checkpoint-dir`` and ``--audit-every`` hand the loop to ``funcsne.fit``
under a ``ResiliencePolicy`` (checkpoints in the JAX package's format,
rollback, the chunk-boundary audit); ``--resume`` continues from the
newest boundary of ``--checkpoint-dir`` that verifies.  The multi-device
and multi-process options of ``repro.launch.embed`` are not ported yet and
raise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import funcsne
from repro_torch.core.resilience import ResiliencePolicy
from repro_torch.core.quality import embedding_quality
from repro_torch.data import synthetic


def load_dataset(name: str, n: int, seed: int = 0):
    if name == "blobs":
        return synthetic.blobs(n=n, n_centers=8, center_std=6.0, seed=seed)
    if name == "cells":
        X, major, _ = synthetic.hierarchical_cells(n=n, seed=seed)
        return X, major
    if name == "coil":
        return synthetic.coil_rings(n_objects=max(4, n // 72),
                                    n_per_object=72, seed=seed)
    if name == "mnist-like":
        return synthetic.mnist_like(n=n, seed=seed)
    raise ValueError(name)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cells",
                    choices=["blobs", "cells", "coil", "mnist-like"])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--iters", type=int, default=1500,
                    help="rounded to a multiple of --chunk")
    ap.add_argument("--chunk", type=int, default=50,
                    help="iterations per chunk (one metrics read each)")
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--perplexity", type=float, default=20.0)
    ap.add_argument("--dim-ld", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="arm checkpoint/rollback resilience")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint-dir via the verified "
                         "fallback chain (damaged boundaries are "
                         "skipped with a checkpoint_fallback event)")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="run the chunk-boundary state auditor every N "
                         "healthy chunks (0 = off); a violation rolls "
                         "back like any health-probe trip")
    for flag in ("--devices", "--num-processes"):
        ap.add_argument(flag, type=int, default=None,
                        help="not ported yet: raises NotImplementedError")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    unported = [f for f in ("devices", "num_processes")
                if getattr(args, f) not in (None, 0, 1)]
    if unported:
        raise NotImplementedError(
            f"options not ported yet: {['--' + f.replace('_', '-') for f in unported]}")

    dev = funcsne.resolve_device(args.device)
    X, _ = load_dataset(args.dataset, args.n)
    Xt = torch.from_numpy(X).to(dev)
    n = X.shape[0]
    T = max(1, min(args.chunk, args.iters))
    n_chunks = max(1, args.iters // T)
    iters = n_chunks * T                 # schedule horizon == steps run
    cfg = funcsne.FuncSNEConfig(n_points=n, dim_hd=X.shape[1],
                                dim_ld=args.dim_ld)
    hp = funcsne.default_hparams(n, alpha=args.alpha,
                                 perplexity=args.perplexity, device=dev)

    if args.checkpoint_dir or args.audit_every:
        # the resilient single-device path: fit owns the loop (checkpoints,
        # verified resume, rollback, the optional audit)
        policy = ResiliencePolicy(checkpoint_dir=args.checkpoint_dir,
                                  audit_every=args.audit_every)
        t0 = time.perf_counter()
        st, _ = funcsne.fit(Xt, cfg=cfg, n_iter=iters, chunk_size=T,
                            hparams=hp, resilience=policy, device=dev,
                            resume_from=args.checkpoint_dir
                            if args.resume else None)
        _sync(dev)
        dt = time.perf_counter() - t0
        q = float(embedding_quality(Xt, st.Y))
        resumed = [e for e in policy.events
                   if e["kind"] == "checkpoint_fallback"]
        note = f", {len(resumed)} damaged boundary(ies) skipped" \
            if resumed else ""
        print(f"[embed] {args.dataset} n={n} iters={iters} chunk={T} "
              f"alpha={args.alpha} device={dev}: {dt:.1f}s (build "
              f"included), R_NX AUC={q:.3f}{note}")
        if args.out:
            np.save(args.out, st.Y.cpu().numpy())
            print(f"[embed] wrote {args.out}")
        return

    st = funcsne.init_state(Xt, cfg, perplexity=hp.perplexity, device=dev)
    chunk = funcsne.make_chunked_step(cfg, T,
                                      schedule=funcsne.default_schedule,
                                      n_iter=iters)

    # warm-up chunk on a copy: the kernels' build never enters the clock
    chunk(funcsne.FuncSNEState(*[t.clone() for t in st]), Xt, hp)
    _sync(dev)

    t0 = time.perf_counter()
    for _ in range(n_chunks):
        st, _, _ = chunk(st, Xt, hp)
    _sync(dev)
    dt = time.perf_counter() - t0

    Y = st.Y.cpu().numpy()
    q = float(embedding_quality(Xt, st.Y))
    print(f"[embed] {args.dataset} n={n} iters={iters} chunk={T} "
          f"alpha={args.alpha} device={dev}: {dt:.1f}s "
          f"({iters / dt:.1f} it/s, build excluded), R_NX AUC={q:.3f}")
    if args.out:
        np.save(args.out, Y)
        print(f"[embed] wrote {args.out}")


if __name__ == "__main__":
    main()
