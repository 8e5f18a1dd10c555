"""Dynamic datasets (paper contribution 2) on the port: points arrive in
waves during one continual optimisation, with no precompute stall.

The counterpart of ``examples/dynamic_stream.py``: 1,800 blobs rows in 24
dimensions, 600 active at the start, three waves of 300 steps in chunks
of 50 with the hyperparameters held, ``add_points`` of the next 600 rows
between waves, then ``remove_points`` of cluster 0 and 100 more steps.
Every wave runs through the resilient chunk loop
(``fit(state=..., resilience=ResiliencePolicy(...))``): the chunk's health
telemetry is checked, the whole state is checkpointed every two healthy
chunks into one directory that spans the session, and a NaN or exploding
chunk would roll back and retry with a backed-off learning rate instead
of ending the session.

  python -m repro_torch.examples.dynamic_stream [--device cpu]

:func:`run_session` is the session itself, for any ``X`` and waves.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import funcsne, threefry
from repro_torch.core.knn import exact_knn
from repro_torch.core.quality import rnx_auc, rnx_curve
from repro_torch.core.resilience import ResiliencePolicy
from repro_torch.data.synthetic import blobs


def _hold(it, n_iter, hp):
    """The hyperparameters held constant within a wave."""
    return hp


def run_session(X, labels, waves, *, n_iter=300, remove_iters=100,
                chunk_size=50, perplexity=12.0, ckdir=None, sample=512,
                on_event=None, log=print, device="cuda"):
    """Run a session: ``waves[0]`` active at the start, ``n_iter`` steps a
    wave, ``add_points(waves[w + 1])`` between waves, then
    ``remove_points`` of the rows with label 0 and ``remove_iters`` steps;
    one ``ResiliencePolicy`` with a checkpoint directory (``ckdir``, or a
    new temporary one) across the whole session.

    After each wave, ``sample`` rows of ``waves[0]`` (active in every
    wave) give the HD lists' recall@k and R_NX AUC against the exact
    neighbours among the active rows.  Returns ``(state, policy, report)``:
    ``report`` holds a dict a wave (``active``, ``seconds``, ``recall``,
    ``auc``) and one for the removal (``active``, ``finite``).
    """
    dev = funcsne.resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
    labels = torch.as_tensor(np.asarray(labels)).to(dev)
    n = X.shape[0]
    waves = [torch.as_tensor(np.asarray(w)).to(dev).long() for w in waves]
    cfg = funcsne.FuncSNEConfig(n_points=n, dim_hd=X.shape[1])
    hp = funcsne.default_hparams(n, perplexity=perplexity, device=dev)
    active = torch.zeros((n,), dtype=torch.bool, device=dev)
    active[waves[0]] = True
    st = funcsne.init_state(X, cfg, active=active, perplexity=hp.perplexity,
                            device=dev)
    # session-lifetime policy: one checkpoint directory spans every wave,
    # so a killed session resumes (fit(resume_from=...)) with whatever
    # points had streamed in by the last committed chunk
    if ckdir is None:
        ckdir = tempfile.mkdtemp(prefix="funcsne-stream-ck-")
    policy = ResiliencePolicy(checkpoint_dir=ckdir, checkpoint_every=2,
                              on_event=on_event)
    rows = waves[0][::max(1, waves[0].shape[0] // sample)][:sample]
    k = cfg.k_hd
    report = []
    for w in range(len(waves)):
        t0 = time.perf_counter()
        st, _ = funcsne.fit(X, cfg=cfg, n_iter=n_iter, chunk_size=chunk_size,
                            hparams=hp, schedule=_hold, state=st,
                            resilience=policy, validate=w == 0, device=dev)
        n_act = int(st.active.sum())
        secs = time.perf_counter() - t0
        # the exact reference excludes the rows not yet arrived, and the
        # R_NX chance correction uses the active count, not the capacity
        true_idx, _ = exact_knn(X, k, active=st.active, rows=rows)
        est = st.hd_idx[rows, :k]
        recall = float((est.long()[:, :, None] == true_idx.long()[:, None, :])
                       .any(-1).float().mean())
        auc = float(rnx_auc(rnx_curve(est, true_idx, n_act)))
        report.append({"active": n_act, "seconds": secs, "recall": recall,
                       "auc": auc})
        log(f"wave {w}: {n_act} active points, {n_iter} iters in "
            f"{secs:.1f}s, knn AUC(sample)={auc:.3f}, recall@{k}="
            f"{recall:.3f}")
        if w + 1 < len(waves):
            st = funcsne.add_points(st, waves[w + 1], threefry.prng_key(w))
            log(f"  + added {waves[w + 1].shape[0]} points mid-run")
    st = funcsne.remove_points(st, torch.nonzero(labels == 0)[:, 0])
    st, _ = funcsne.fit(X, cfg=cfg, n_iter=remove_iters,
                        chunk_size=chunk_size, hparams=hp, schedule=_hold,
                        state=st, resilience=policy, validate=False,
                        device=dev)
    finite = bool(torch.isfinite(st.Y).all())
    report.append({"active": int(st.active.sum()), "finite": finite})
    log(f"removed cluster 0 -> {report[-1]['active']} active; embedding "
        f"finite: {finite}; {len(policy.events)} resilience events; "
        f"checkpoints in {ckdir}")
    return st, policy, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    n_total, wave = 1800, 600
    X, labels = blobs(n=n_total, dim=24, n_centers=6, center_std=6.0, seed=0)
    waves = [np.arange(i * wave, (i + 1) * wave) for i in range(3)]
    run_session(X, labels, waves, on_event=lambda e: print(
        f"  [resilience] {e}"), device=args.device)


if __name__ == "__main__":
    main()
