#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Drives the port's main path (``repro_torch``: ``init_state`` and the chunk
runner with ``default_schedule``, the single-device route of
``python -m repro_torch.launch.embed``) at MNIST's shape, n = 70,000 and
dim_hd = 784, on an MNIST-shaped synthetic dataset, and checks it:

  (a) build the CUDA kernels from ``src/repro_torch/csrc``; print the card;
  (b) hold each kernel against its plain PyTorch version on the card, at the
      main path's shapes: ids and flags exact on quantised inputs, floats
      within the stated tolerances, the force kernel bit-identical over two
      launches;
  (c) one full step from one state through the kernels and through the
      plain versions: discrete fields exact, floats within tolerance;
  (d) the main path itself with the launch counters set to 0 just before:
      every kernel launched, Y finite, the HD lists' recall against exact
      neighbours on a fixed 2,000-row subsample above RECALL_MIN, steps/s
      and the R_NX AUC on a 5,000-row subsample;
  (e) each kernel's time (CUDA events) beside its bound and its plain
      version's time, and a short profiler window of the step.

Any failed check raises, so the script exits non-zero.  The second-to-last
line is the card's name and power limit; before it, one JSON line with the
kernels; the last line is the device record.  It needs no network, imports
nothing of JAX, and fails where there is no CUDA device or no repository
beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

N, DIM = 70_000, 784
ITERS, CHUNK = 500, 50
RECALL_ROWS, AUC_ROWS = 2_000, 5_000
# HD-list recall@32 after ITERS steps must exceed this.  The run is
# deterministic; on an H100 it reached 0.5691, and the random initial lists
# score about 32/70,000 = 0.0005 (both printed beside it)
RECALL_MIN = 0.4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
FP32_FLOPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
# tolerances of the float comparisons, kernel vs plain version on the card
TOL_SQDIST_REL = 1e-5          # sum over 784 columns in another order
TOL_FORCE_REL = 1e-5           # of each field's largest entry
TOL_STEP_REL = 1e-4            # Y / vel / zhat after one step


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def nbytes(*tensors):
    seen, total = set(), 0
    for t in tensors:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def bound(bytes_, flops):
    tb, tf = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


class Recorder:
    """Ops that record the arguments of each call, then run the kernel."""

    def __init__(self, funcsne):
        self.calls = {}
        k = funcsne.KERNELS

        def rec(name, fn):
            def f(*args, **kw):
                key = name
                if name == "knn_merge_cand":
                    key += "_ld" if args[3] is None else "_hd"
                elif name == "pairwise_sqdist_gather":
                    key += "_hd" if args[0].shape[1] > 2 else "_ld"
                self.calls.setdefault(key, (args, kw))
                return fn(*args, **kw)
            return f
        self.ops = funcsne.Ops(
            rec("pairwise_sqdist_gather", k.pairwise_sqdist_gather),
            rec("knn_merge_cand", k.knn_merge_cand),
            rec("ne_forces_scatter", k.ne_forces_scatter))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import kernels
    from repro_torch.core import funcsne, knn
    from repro_torch.core.quality import embedding_quality
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.knn_merge.ops import knn_merge_cand
    from repro_torch.kernels.knn_merge.ref import knn_merge_cand_ref
    from repro_torch.kernels.ne_forces.ops import ne_forces_scatter
    from repro_torch.kernels.ne_forces.ref import ne_forces_scatter_ref
    from repro_torch.kernels.pairwise_sqdist.ops import pairwise_sqdist_gather
    from repro_torch.kernels.pairwise_sqdist.ref import (
        pairwise_sqdist_gather_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    t_start = time.perf_counter()

    # ---- (a) build and device ------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"[a] built {lib.name} in {time.perf_counter() - t0:.1f}s on "
        f"{torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    build_log = (lib.parent / f"build_{_build.source_tag()}.log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log(f"    {line.strip()}")

    X_np, _ = synthetic.mnist_like(n=N, dim=DIM, seed=0)
    X = torch.from_numpy(X_np).to(dev)
    Xq = torch.round(X)            # integer features: exact distances
    cfg = funcsne.FuncSNEConfig(n_points=N, dim_hd=DIM)
    hp = funcsne.default_hparams(N, device=dev)
    log(f"    X {tuple(X.shape)} {X.numel() * 4 / 1e6:.1f} MB on the card")

    # ---- (b) each kernel against its plain version ----------------------
    # one step on quantised data through recording ops gives every kernel's
    # main-path inputs (the gate always fires at step 0: E[N_new/N] = 1)
    rec = Recorder(funcsne)
    stq = funcsne.init_state(Xq, cfg, seed=1, device=dev, ops=rec.ops)
    stq = stq._replace(Y=torch.round(stq.Y * 400.0) / 4.0)  # quarter grid
    funcsne.funcsne_step(cfg, stq, Xq, hp, ops=rec.ops)
    check(set(rec.calls) == {"pairwise_sqdist_gather_hd",
                             "pairwise_sqdist_gather_ld",
                             "knn_merge_cand_hd", "knn_merge_cand_ld",
                             "ne_forces_scatter"}, f"calls {set(rec.calls)}")
    errs = {}

    for mode in ("hd", "ld"):
        (x, qid, cand), _ = rec.calls[f"pairwise_sqdist_gather_{mode}"]
        x = Xq if mode == "hd" else stq.Y          # both on integer grids
        got = pairwise_sqdist_gather(x, qid, cand)
        want = pairwise_sqdist_gather_ref(x, qid, cand)
        check(torch.equal(got, want), f"B1 {mode} not exact on quantised x")
        log(f"[b] B1 pairwise_sqdist_gather {mode}: x {tuple(x.shape)} "
            f"cand {tuple(cand.shape)}: exact on quantised inputs")
    (x, qid, cand), _ = rec.calls["pairwise_sqdist_gather_hd"]
    got = pairwise_sqdist_gather(X, qid, cand)
    want = pairwise_sqdist_gather_ref(X, qid, cand)
    rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    check(rel <= TOL_SQDIST_REL, f"B1 real-X relative error {rel}")
    errs["pairwise_sqdist_gather"] = max_err(got, want)
    log(f"    B1 on the real X: max abs err {errs['pairwise_sqdist_gather']:.3e}, "
        f"max rel {rel:.3e} (tol {TOL_SQDIST_REL})")
    del got, want

    for mode in ("hd", "ld"):
        args, kw = rec.calls[f"knn_merge_cand_{mode}"]
        got = knn_merge_cand(*args, **kw)
        want = knn_merge_cand_ref(*args, **kw)
        for g, w, name in zip(got, want, ("idx", "d", "improved")):
            check(torch.equal(g, w), f"B2 {mode} {name} differs")
        errs[f"knn_merge_cand_{mode}"] = max_err(got[1][torch.isfinite(want[1])],
                                                 want[1][torch.isfinite(want[1])])
        log(f"[b] B2 knn_merge_cand {mode}: x {tuple(args[0].shape)} K="
            f"{args[2].shape[1]}: idx/d/improved exact on quantised inputs "
            f"({int(got[2].sum())} rows improved)")

    (y, qid, nbr, coef, alpha), kw = rec.calls["ne_forces_scatter"]
    got = ne_forces_scatter(y, qid, nbr, coef, alpha, **kw)
    again = ne_forces_scatter(y, qid, nbr, coef, alpha, **kw)
    want = ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw)
    for g, a in zip(got[0] + got[1], again[0] + again[1]):
        check(torch.equal(g, a), "B3 not bit-identical over two launches")
    e3 = 0.0
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        e = max_err(g, w)
        scale = float(w.abs().max())
        check(e <= TOL_FORCE_REL * scale, f"B3 err {e} vs scale {scale}")
        e3 = max(e3, e)
    errs["ne_forces_scatter"] = e3
    log(f"[b] B3 ne_forces_scatter: y {tuple(y.shape)} nbr {tuple(nbr.shape)}: "
        f"bit-identical over two launches; max abs err {e3:.3e} "
        f"(tol {TOL_FORCE_REL} of each field's largest entry)")

    # ---- (c) one full step, kernels vs plain versions -------------------
    st_k = funcsne.funcsne_step(cfg, stq, Xq, hp, ops=funcsne.KERNELS)
    st_p = funcsne.funcsne_step(cfg, stq, Xq, hp, ops=funcsne.PLAIN)
    for name in ("hd_idx", "hd_d", "ld_idx", "new_flag", "step", "ema_new_frac"):
        check(torch.equal(getattr(st_k, name), getattr(st_p, name)),
              f"step {name} differs")
    for name in ("Y", "vel", "zhat"):
        a, b = getattr(st_k, name), getattr(st_p, name)
        e = max_err(a, b)
        check(e <= TOL_STEP_REL * float(b.abs().max()),
              f"step {name}: err {e}")
    check(float((st_k.gains != st_p.gains).float().mean()) < 1e-3,
          "step gains differ on more than 0.1% of entries")
    log(f"[c] one step, kernels vs plain: hd_idx/hd_d/ld_idx/new_flag exact, "
        f"Y/vel/zhat within {TOL_STEP_REL} of their largest entry")
    del st_k, st_p, stq, rec

    # ---- (d) the main path at full width ---------------------------------
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = funcsne.init_state(X, cfg, seed=0, perplexity=hp.perplexity,
                            device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rows = torch.randperm(N, generator=torch.Generator().manual_seed(1))[
        :RECALL_ROWS].to(dev)
    true_idx, _ = knn.exact_knn(X, cfg.k_hd, rows=rows)

    def recall(hd_idx):
        est = hd_idx[rows].long()
        hit = (est[:, :, None] == true_idx.long()[:, None, :]).any(-1)
        return float(hit.float().mean())
    recall0 = recall(st.hd_idx)
    chunk = funcsne.make_chunked_step(cfg, CHUNK,
                                      schedule=funcsne.default_schedule,
                                      n_iter=ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS // CHUNK):
        st, metrics = chunk(st, X, hp)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"[d] main path: init {t_init:.2f}s, {ITERS} steps in {t_run:.2f}s "
        f"= {ITERS / t_run:.1f} steps/s; launches {launches}")
    for name, cnt in launches.items():
        check(cnt > 0, f"kernel {name} never launched on the main path")
    check(bool(torch.isfinite(st.Y).all()), "Y not finite")
    rec1 = recall(st.hd_idx)
    sub = torch.randperm(N, generator=torch.Generator().manual_seed(2))[
        :AUC_ROWS].to(dev)
    auc = float(embedding_quality(X[sub], st.Y[sub]))
    log(f"    HD recall@{cfg.k_hd} on {RECALL_ROWS} rows: {rec1:.4f} "
        f"(initial random lists {recall0:.5f}, threshold {RECALL_MIN}); "
        f"R_NX AUC on {AUC_ROWS} rows {auc:.4f}; zhat {float(st.zhat):.4g}, "
        f"E[N_new/N] {float(st.ema_new_frac):.4f}, "
        f"max|Y| {float(metrics.y_max_abs):.4g}")
    check(rec1 > RECALL_MIN, f"HD recall {rec1} <= {RECALL_MIN}")

    # ---- (e) per-kernel times -------------------------------------------
    out = []

    def entry(name, source, replaces, fn, plain, reps, bytes_, flops, err,
              count):
        ms = time_ms(fn, reps)
        plain_ms = time_ms(plain, max(2, reps // 10))
        b_ms, b_by = bound(bytes_, flops)
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": count,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        log(f"[e] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms:.1%} of it), plain {plain_ms:.3f} ms")

    # the final main-path state gives the timed inputs
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    cand = knn.init_knn_idx(torch.Generator().manual_seed(3), N, N, cfg.k_hd,
                            device=dev)
    out_b = torch.empty((N, cfg.k_hd), device=dev)
    entry("pairwise_sqdist_gather", "src/repro_torch/csrc/pairwise_sqdist.cu",
          "src/repro/kernels/pairwise_sqdist/kernel.py:278",
          lambda: pairwise_sqdist_gather(X, ids, cand),
          lambda: pairwise_sqdist_gather_ref(X, ids, cand), 10,
          nbytes(X, ids, cand, out_b), 3.0 * N * cfg.k_hd * DIM,
          errs["pairwise_sqdist_gather"],
          launches["pairwise_sqdist_gather"])
    del out_b

    rec = Recorder(funcsne)
    base = knn.key_salt(st.rng)
    st_t = funcsne._hd_refine(cfg, st, X, base, rec.ops)
    funcsne._ld_refine(cfg, st_t, base, rec.ops)
    funcsne._forces_update(cfg, st_t, hp, base, rec.ops)
    for mode, m_cols in (("hd", DIM), ("ld", cfg.dim_ld)):
        args, kw = rec.calls[f"knn_merge_cand_{mode}"]
        x, qid, cur_idx, cur_d = args
        c_cand = knn.counter_candidates(kw["salt"], qid, kw["sources"],
                                        kw["first_tables"],
                                        kw["second_tables"], n_total=N)
        valid = knn.dedup_candidates(qid, cur_idx, c_cand) \
            & kw["active"][c_cand.long().clamp(0, N - 1)]
        scored = int(valid.sum()) + (int(kw["cur_valid"].sum())
                                     if cur_d is None else 0)
        outs = knn_merge_cand_ref(*args, **kw)
        entry(f"knn_merge_cand_{mode}", "src/repro_torch/csrc/knn_merge.cu",
              "src/repro/kernels/knn_merge/kernel.py:507",
              lambda: knn_merge_cand(*args, **kw),
              lambda: knn_merge_cand_ref(*args, **kw), 20,
              nbytes(x, qid, cur_idx, cur_d, kw["salt"], kw["active"],
                     kw.get("cur_valid"), *kw["first_tables"],
                     *kw["second_tables"], *outs),
              3.0 * scored * m_cols, errs[f"knn_merge_cand_{mode}"],
              launches[f"knn_merge_cand_{mode}"])
        log(f"    {mode}: {scored} rows scored "
            f"({valid.float().mean():.3f} of candidates new)")

    (y, qid, nbr, coef, alpha), kw = rec.calls["ne_forces_scatter"]
    scats, wsums = ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw)
    entry("ne_forces_scatter", "src/repro_torch/csrc/ne_forces.cu",
          "src/repro/kernels/ne_forces/kernel.py:451",
          lambda: ne_forces_scatter(y, qid, nbr, coef, alpha, **kw),
          lambda: ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw), 50,
          nbytes(y, qid, nbr, coef, alpha, *scats, *wsums),
          20.0 * nbr.numel(), errs["ne_forces_scatter"],
          launches["ne_forces_scatter"])

    # where a step's time goes: each phase's wall time (host clock around
    # synchronised calls) at the final state, then device time by kernel
    def wall_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3
    hp_t = funcsne.default_schedule(st.step, ITERS, hp)
    k_ops = funcsne.KERNELS
    phase = {
        "gate": lambda: bool(knn.counter_uniform01(knn.hash3(
            knn.key_salt(st.rng), st.step, 1)) < st.ema_new_frac),
        "hd_refine": lambda: funcsne._hd_refine(cfg, st, X, base, k_ops),
        "sigma_refresh": lambda: funcsne._sigma_refresh(cfg, st, hp_t),
        "ld_refine": lambda: funcsne._ld_refine(cfg, st, base, k_ops),
        "forces_update": lambda: funcsne._forces_update(cfg, st, hp_t, base,
                                                        k_ops),
        "schedule": lambda: funcsne.default_schedule(st.step, ITERS, hp),
    }
    share = {"hd_refine": launches["knn_merge_cand_hd"] / ITERS,
             "sigma_refresh": 1.0 / cfg.sigma_refresh_every}
    per_step = 0.0
    for name, fn in phase.items():
        ms = wall_ms(fn)
        per_step += ms * share.get(name, 1.0)
        log(f"[e] phase {name}: {ms:.3f} ms per call, runs in "
            f"{share.get(name, 1.0):.3f} of steps")
    log(f"    phases add up to {per_step:.3f} ms per step; the main path "
        f"took {t_run / ITERS * 1e3:.3f} ms per step")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    win = funcsne.make_chunked_step(cfg, 20, schedule=funcsne.default_schedule,
                                    n_iter=ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        win(st, X, hp)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    # kernel events only: an aten op's row repeats its kernels' time
    rows_p = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows_p)       # 0 if the profiler saw no kernel
    step_ms = t_run / ITERS * 1e3
    log(f"[e] profiler, 20 steps: device busy {busy / 20:.3f} ms/step; the "
        f"unprofiled main path took {step_ms:.3f} ms/step, so the device "
        f"idles about {1 - busy / 20 / step_ms:.1%} of a step (wall with the "
        f"profiler on: {wall:.1f} ms); device time by kernel:")
    for key, ms, cnt in sorted(rows_p, key=lambda r: -r[1])[:12]:
        log(f"    {ms:9.3f} ms  {cnt:5d}x  {key[:90]}")
    log(f"    total {time.perf_counter() - t_start:.1f}s")

    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
