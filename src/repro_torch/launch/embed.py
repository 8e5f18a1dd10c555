"""End-to-end FUnc-SNE embedding launcher of the port.

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
newest boundary of ``--checkpoint-dir`` that verifies.

``--devices N`` (N > 1) starts N ranks on this machine
(``launch.mesh.run_ranks``: NCCL where every rank has a card of its own,
gloo on the CPU or where ranks share a card) and each runs
``runtime.coordinator.fit_elastic`` on a grid with the requested model
width ``--model`` (the largest feasible width, as the reference's remesh),
with ``--checkpoint-dir`` / ``--resume`` / ``--audit-every`` as its
policy; rank 0 prints the reference's ``[embed]`` line and the backend:

  PYTHONPATH=src python -m repro_torch.launch.embed --devices 2 --model 2 \
      --device cpu --dataset blobs --n 256 --iters 20

``--hosts H`` splits those ranks into H simulated hosts (each writes its
own row shard of every checkpoint; ``fit_elastic``'s host loss drops one).
``--num-processes N --process-id I --coordinator H:P`` joins a real
multi-process pod instead: every process runs this command with the same
coordinator and its own id, joins one ``torch.distributed`` process group
and runs ``fit_elastic`` on it (each process checkpoints its own
generation-tagged row shard); process 0 prints the ``[embed]`` line:

  PYTHONPATH=src python -m repro_torch.launch.embed --num-processes 2 \
      --process-id 0 --coordinator 127.0.0.1:29500 --device cpu ...
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


def _embed_rank(rank, world, dev, args):
    """One rank of ``--devices`` or one process of ``--num-processes``:
    ``fit_elastic`` on the grid; rank 0 returns the ``[embed]`` line's
    numbers and Y, the others None."""
    import torch.distributed as dist

    from repro_torch.runtime.coordinator import fit_elastic

    args = argparse.Namespace(**args)
    X, _ = load_dataset(args.dataset, args.n)
    Xt = torch.from_numpy(X).to(dev)
    n = X.shape[0]
    cfg = funcsne.FuncSNEConfig(n_points=n, dim_hd=X.shape[1],
                                dim_ld=args.dim_ld)
    hp = funcsne.default_hparams(n, alpha=args.alpha,
                                 perplexity=args.perplexity, device=dev)
    policy = ResiliencePolicy(checkpoint_dir=args.checkpoint_dir,
                              audit_every=args.audit_every) \
        if args.checkpoint_dir or args.audit_every else None
    t0 = time.perf_counter()
    st = fit_elastic(Xt, cfg=cfg, n_iter=args.iters, chunk_size=args.chunk,
                     hparams=hp, n_hosts=args.hosts, model=args.model,
                     resilience=policy,
                     resume_from=args.checkpoint_dir if args.resume else None,
                     device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    if rank != 0:
        return None
    return {"n": n, "dt": dt, "auc": float(embedding_quality(Xt, st.Y)),
            "Y": st.Y.cpu().numpy(), "backend": dist.get_backend()}


def _join_pod(args, dev, run):
    """This process's part of a real pod: join the process group at
    ``--coordinator`` and run :func:`_embed_rank`; process 0 returns the
    ``[embed]`` line's numbers."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import join_group

    rdev = join_group(dev, args.num_processes, args.process_id,
                      f"tcp://{args.coordinator}")
    try:
        return _embed_rank(args.process_id, args.num_processes, rdev, run)
    finally:
        dist.destroy_process_group()


def _print_pod_line(args, res, iters, T, dev):
    n_dev = args.num_processes if args.num_processes > 1 else args.devices
    print(f"[embed] {args.dataset} n={res['n']} iters={iters} chunk={T} "
          f"devices={n_dev} model={args.model} hosts={args.hosts} "
          f"processes={args.num_processes} backend={res['backend']} "
          f"device={dev.type}: {res['dt']:.1f}s (build included), "
          f"R_NX AUC={res['auc']:.3f}")
    if args.out:
        np.save(args.out, res["Y"])
        print(f"[embed] wrote {args.out}")


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
    ap.add_argument("--devices", type=int, default=1,
                    help=">1 starts that many ranks on this machine, each "
                         "running runtime.coordinator.fit_elastic on a "
                         "(data, model) grid (NCCL where each rank has a "
                         "card of its own, else gloo)")
    ap.add_argument("--model", type=int, default=1,
                    help="requested model-axis width (the largest feasible "
                         "width <= this is used)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="simulated hosts (contiguous blocks of the "
                         "--devices ranks); per-host checkpoint shard files "
                         "when --checkpoint-dir is set")
    ap.add_argument("--num-processes", type=int, default=1,
                    help=">1 joins a real multi-process pod: every process "
                         "runs this command with the same --coordinator "
                         "and a distinct --process-id")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank in the pod (required when "
                         "--num-processes > 1)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's process-group store "
                         "(required when --num-processes > 1)")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    multiprocess = args.num_processes > 1
    if multiprocess:
        if args.process_id is None or args.coordinator is None:
            ap.error("--num-processes > 1 requires --process-id "
                     "and --coordinator")
        if args.hosts != 1:
            ap.error("--hosts simulates a pod on one process; a real "
                     "multi-process pod must keep --hosts 1")

    dev = funcsne.resolve_device(args.device)
    T = max(1, min(args.chunk, args.iters))
    n_chunks = max(1, args.iters // T)
    iters = n_chunks * T                 # schedule horizon == steps run
    run = dict(vars(args), iters=iters, chunk=T)
    if multiprocess:
        res = _join_pod(args, dev, run)
        if res is not None:
            _print_pod_line(args, res, iters, T, dev)
        return
    if args.devices > 1:
        from repro_torch.launch.mesh import run_ranks
        # the elastic loop owns the run on every rank (reduced health
        # probes, per-host checkpoint shards, rollback, host loss)
        res = run_ranks(_embed_rank, args.devices, (run,), device=dev,
                        timeout=None)[0]
        _print_pod_line(args, res, iters, T, dev)
        return

    X, _ = load_dataset(args.dataset, args.n)
    Xt = torch.from_numpy(X).to(dev)
    n = X.shape[0]
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
