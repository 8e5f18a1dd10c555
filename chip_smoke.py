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
      version's time, and a short profiler window of the step;
  (f) the flag paths (gather_fused=False, scatter_fused=False,
      merge_fused=False, c_hd_rev=4, cand_fused=False), each from the main
      path's final state: its kernels against their plain versions at its
      shapes, one step through the kernels against one through the plain
      versions, then F_ITERS steps with the launch counters set to 0 just
      before (its own kernels launched, no other; Y finite; recall above
      RECALL_MIN and above the recall of the state it started from; steps/s
      beside the default path's from the same state); B6 also at
      init_state's C = 32 and at C = 14 of c_hd_rev = 4; the times of B5-B7
      and of B4 at FUnc-SNE's HD and LD-rescore shapes; and the cost of the
      threefry draws of one cand_fused=False step;
  (g) nearest-neighbour descent (``repro_torch.core.nnd``, ``NNDConfig()``)
      on the same X: B4 at C = 16 against its plain version, one iteration
      through the kernels against one through the plain versions, then
      ``nnd(max_iter=NND_ITERS, tol=1e-3)`` with the launch counters set to
      0 just before (B1 once, B4 once per iteration, nothing else; the
      update fraction falls; recall above RECALL_MIN), iterations/s, the
      recall after NND_SHORT iterations, and the time of B4 at NND's shape.

Phase (b) also holds threefry's draws made on the card (randint at
(70,000, 10) with spans 70,000 and 32, bernoulli, a fold_in/split chain)
against the same draws made on the CPU, bit for bit.

Any failed check raises, so the script exits non-zero.  The second-to-last
line is the card's name and power limit; before it, one JSON line with the
kernels; the last line is the device record.  It needs no network, imports
nothing of JAX, and fails where there is no CUDA device or no repository
beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

N, DIM = 70_000, 784
ITERS, CHUNK = 500, 50
F_ITERS = 100                  # steps of each flag path in phase (f)
# most NND iterations in phase (g).  NND samples 16 candidates per row and
# iteration, so at n = 70,000 its update fraction stays near 1 for the first
# tens of iterations; phase (g) also prints the recall after NND_SHORT
NND_ITERS, NND_SHORT = 150, 40
RECALL_ROWS, AUC_ROWS = 2_000, 5_000
# HD-list recall@32 after ITERS steps (and after NND) must exceed this.  The
# run is deterministic and prints its recall beside the random initial
# lists' (about 32/70,000 = 0.0005)
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
    """Ops that record each call as (entry point, args, kw), then run the
    kernel.

    Calls are keyed by the entry point's name, with _hd / _ld for B1, B2
    and B4 and the call's index for B7 (three calls a step)."""

    def __init__(self, funcsne):
        self.calls = {}
        n_b7 = [0]

        def rec(name, fn):
            def f(*args, **kw):
                key = name
                if name in ("knn_merge_cand", "knn_merge"):
                    key += "_ld" if args[3] is None else "_hd"
                elif name == "pairwise_sqdist_gather":
                    key += "_hd" if args[0].shape[1] > 2 else "_ld"
                elif name == "ne_forces":
                    key += f"_{n_b7[0]}"
                    n_b7[0] += 1
                self.calls.setdefault(key, (name, args, kw))
                return fn(*args, **kw)
            return f
        self.ops = funcsne.Ops(*[rec(name, fn) for name, fn in
                                 zip(funcsne.Ops._fields, funcsne.KERNELS)])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import kernels
    from repro_torch.core import funcsne, knn, nnd, threefry
    from repro_torch.core.quality import embedding_quality
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.knn_merge.ops import knn_merge, knn_merge_cand
    from repro_torch.kernels.knn_merge.ref import (knn_merge_cand_ref,
                                                   knn_merge_ref)
    from repro_torch.kernels.ne_forces.ops import (ne_forces,
                                                   ne_forces_gather,
                                                   ne_forces_scatter)
    from repro_torch.kernels.ne_forces.ref import (ne_forces_gather_ref,
                                                   ne_forces_ref,
                                                   ne_forces_scatter_ref)
    from repro_torch.kernels.pairwise_sqdist.ops import (
        pairwise_sqdist, pairwise_sqdist_gather)
    from repro_torch.kernels.pairwise_sqdist.ref import (
        pairwise_sqdist_gather_ref, pairwise_sqdist_ref)

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
        _, (x, qid, cand), _ = rec.calls[f"pairwise_sqdist_gather_{mode}"]
        x = Xq if mode == "hd" else stq.Y          # both on integer grids
        got = pairwise_sqdist_gather(x, qid, cand)
        want = pairwise_sqdist_gather_ref(x, qid, cand)
        check(torch.equal(got, want), f"B1 {mode} not exact on quantised x")
        log(f"[b] B1 pairwise_sqdist_gather {mode}: x {tuple(x.shape)} "
            f"cand {tuple(cand.shape)}: exact on quantised inputs")
    _, (x, qid, cand), _ = rec.calls["pairwise_sqdist_gather_hd"]
    got = pairwise_sqdist_gather(X, qid, cand)
    want = pairwise_sqdist_gather_ref(X, qid, cand)
    rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    check(rel <= TOL_SQDIST_REL, f"B1 real-X relative error {rel}")
    errs["pairwise_sqdist_gather"] = max_err(got, want)
    log(f"    B1 on the real X: max abs err {errs['pairwise_sqdist_gather']:.3e}, "
        f"max rel {rel:.3e} (tol {TOL_SQDIST_REL})")
    del got, want

    for mode in ("hd", "ld"):
        _, args, kw = rec.calls[f"knn_merge_cand_{mode}"]
        got = knn_merge_cand(*args, **kw)
        want = knn_merge_cand_ref(*args, **kw)
        for g, w, name in zip(got, want, ("idx", "d", "improved")):
            check(torch.equal(g, w), f"B2 {mode} {name} differs")
        errs[f"knn_merge_cand_{mode}"] = max_err(got[1][torch.isfinite(want[1])],
                                                 want[1][torch.isfinite(want[1])])
        log(f"[b] B2 knn_merge_cand {mode}: x {tuple(args[0].shape)} K="
            f"{args[2].shape[1]}: idx/d/improved exact on quantised inputs "
            f"({int(got[2].sum())} rows improved)")

    _, (y, qid, nbr, coef, alpha), kw = rec.calls["ne_forces_scatter"]
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

    # threefry on the card against the CPU (which the tests hold to
    # jax.random): a key chain made on the card, and draws made on the card
    # from a card key and from a host key
    key_h = threefry.prng_key(0)
    chain_h = threefry.split(threefry.fold_in(key_h, 12345), 4)
    chain_d = threefry.split(threefry.fold_in(key_h.to(dev), 12345), 4)
    check(chain_d.is_cuda and torch.equal(chain_d.cpu(), chain_h),
          "threefry fold_in/split chain differs on the card")
    for span in (N, 32):
        want = threefry.randint(chain_h[1], (N, 10), 0, span)
        for k in (chain_h[1], chain_d[1]):
            got = threefry.randint(k, (N, 10), 0, span, device=dev)
            check(got.is_cuda and torch.equal(got.cpu(), want),
                  f"threefry randint span {span} differs on the card")
    p_grid = torch.linspace(0.0, 1.0, N)
    want = threefry.bernoulli(chain_h[2], p_grid)
    for k in (chain_h[2], chain_d[2]):
        got = threefry.bernoulli(k, p_grid.to(dev))
        check(torch.equal(got.cpu(), want),
              "threefry bernoulli differs on the card")
    nd, nh = (threefry.normal(chain_d[3], (N, 2)).cpu(),
              threefry.normal(chain_h[3], (N, 2)))
    ulps = int((nd.view(torch.int32).long()
                - nh.view(torch.int32).long()).abs().max())
    log(f"[b] threefry on the card: fold_in/split chain, randint (N, 10) at "
        f"spans {N} and 32, bernoulli (N,): bit-identical to the CPU; normal "
        f"(N, 2) within {ulps} ulps of the CPU (reported, not checked)")

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
    main_kernels = {"pairwise_sqdist_gather", "knn_merge_cand_hd",
                    "knn_merge_cand_ld", "ne_forces_scatter"}
    for name, cnt in launches.items():
        check((cnt > 0) == (name in main_kernels),
              f"kernel {name}: {cnt} launches on the main path")
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
              count, library=None, tag="[e]"):
        ms = time_ms(fn, reps)
        plain_ms = time_ms(plain, max(2, reps // 10))
        lib_ms = None if library is None else time_ms(library,
                                                      max(2, reps // 10))
        b_ms, b_by = bound(bytes_, flops)
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": count,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        log(f"{tag} {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms:.1%} of it), plain {plain_ms:.3f} ms"
            + ("" if lib_ms is None else f", library {lib_ms:.3f} ms"))

    # the final main-path state gives the timed inputs
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    cand = knn.init_knn_idx(threefry.prng_key(3), N, N, cfg.k_hd, device=dev)
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
        _, args, kw = rec.calls[f"knn_merge_cand_{mode}"]
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

    _, (y, qid, nbr, coef, alpha), kw = rec.calls["ne_forces_scatter"]
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
    del prof, rows_p

    # ---- (f) the flag paths ----------------------------------------------
    # (flags, the launch counters its F_ITERS steps must move; every other
    # counter must stay at 0)
    b2, b3 = {"knn_merge_cand_hd", "knn_merge_cand_ld"}, {"ne_forces_scatter"}
    paths = {
        "default": ({}, b2 | b3),
        "gather_fused=False": (dict(gather_fused=False),
                               {"pairwise_sqdist", "ne_forces"}),
        "scatter_fused=False": (dict(scatter_fused=False),
                                b2 | {"ne_forces_gather"}),
        "merge_fused=False": (dict(merge_fused=False),
                              {"pairwise_sqdist_gather"} | b3),
        "c_hd_rev=4": (dict(c_hd_rev=4), b2 | b3),
        "cand_fused=False": (dict(cand_fused=False),
                             {"knn_merge_hd", "knn_merge_ld"} | b3),
        "default, again": ({}, b2 | b3),   # brackets the flag paths' times
    }
    exact_ops = {"pairwise_sqdist_gather", "knn_merge_cand", "pairwise_sqdist",
                 "knn_merge"}

    def flat(v):
        return [t for x in v for t in flat(x)] if isinstance(v, tuple) \
            else [v]

    def held(key, op, args, kw, quantised):
        """Kernel vs plain version on one recorded call; returns the max
        abs error (exact on quantised inputs for the scoring kernels)."""
        got = flat(getattr(funcsne.KERNELS, op)(*args, **kw))
        want = flat(getattr(funcsne.PLAIN, op)(*args, **kw))
        err = 0.0
        for g, w in zip(got, want):
            check((g is None) == (w is None), f"{key}: None outputs differ")
            if w is None:
                continue
            if op in exact_ops and quantised:
                check(torch.equal(g, w), f"{key} not exact on quantised input")
            elif op == "knn_merge" and w.dtype == torch.float32:
                # distances; on the real X a near tie may swap two ids
                fin = torch.isfinite(w)
                check(torch.equal(torch.isfinite(g), fin),
                      f"{key}: +inf slots differ")
                rel = float(((g[fin] - w[fin]).abs()
                             / w[fin].abs().clamp_min(1.0)).max())
                check(rel <= TOL_SQDIST_REL, f"{key} relative error {rel}")
            elif op == "pairwise_sqdist":
                rel = float(((g - w).abs() / w.abs().clamp_min(1.0)).max())
                check(rel <= TOL_SQDIST_REL, f"{key} relative error {rel}")
            elif op in exact_ops:
                continue
            else:
                e = max_err(g, w)
                check(e <= TOL_FORCE_REL * float(w.abs().max()),
                      f"{key} err {e}")
            fin = torch.isfinite(w)
            err = max(err, max_err(g[fin], w[fin]) if fin.any() else 0.0)
        return err

    def forced(s):
        # E[N_new/N] = 1 makes the refinement gate fire
        return s._replace(ema_new_frac=torch.ones_like(s.ema_new_frac))

    scale = 256.0 / float(st.Y.abs().max())     # |Y| <= 64 on a quarter grid
    rec_start = recall(st.hd_idx)      # each path must refine past its start
    hp_f = funcsne.default_schedule(st.step, ITERS + F_ITERS, hp)
    f_err, f_rec, f_launch, f_sps = {}, {}, {}, {}
    for label, (flags, expect) in paths.items():
        cfg_f = dataclasses.replace(cfg, **flags)
        st0 = st
        if cfg_f.c_hd_rev:        # an empty table, due at the first refinement
            st0 = st._replace(
                rev_idx=torch.zeros((N, cfg_f.c_hd_rev), dtype=torch.int32,
                                    device=dev),
                rev_step=st.step - cfg_f.rev_refresh)
        if flags:
            stq = forced(st0._replace(Y=torch.round(st0.Y * scale) / 4.0))
            recq, recr = Recorder(funcsne), Recorder(funcsne)
            funcsne.funcsne_step(cfg_f, stq, Xq, hp_f, ops=recq.ops)
            funcsne.funcsne_step(cfg_f, forced(st0), X, hp_f, ops=recr.ops)
            for key, call in recq.calls.items():
                held(key, *call, True)
            for key, call in recr.calls.items():
                f_err[key] = held(key, *call, False)
            if "ne_forces_gather" in recr.calls:
                _, _, kw_g = recr.calls["ne_forces_gather"]
                check(kw_g["emit_edges"] == (True, True, False),
                      "B5 must not emit the negatives' edges")
            f_rec[label] = recr
            log(f"[f] {label}: kernels vs plain at this path's shapes: "
                f"{sorted(recq.calls)} (scoring exact on quantised inputs)")
            st_k = funcsne.funcsne_step(cfg_f, stq, Xq, hp_f,
                                        ops=funcsne.KERNELS)
            st_p = funcsne.funcsne_step(cfg_f, stq, Xq, hp_f,
                                        ops=funcsne.PLAIN)
            for name in ("hd_idx", "hd_d", "ld_idx", "new_flag", "step",
                         "ema_new_frac", "rev_idx", "rev_step"):
                check(torch.equal(getattr(st_k, name), getattr(st_p, name)),
                      f"{label} step {name} differs")
            for name in ("Y", "vel", "zhat"):
                a, b = getattr(st_k, name), getattr(st_p, name)
                e = max_err(a, b)
                check(e <= TOL_STEP_REL * float(b.abs().max()),
                      f"{label} step {name}: err {e}")
            # reported, not checked: the index_add_ symmetrisation of the
            # unfused force paths adds with atomics
            y2 = funcsne.funcsne_step(cfg_f, stq, Xq, hp_f,
                                      ops=funcsne.KERNELS).Y
            log(f"    one step, kernels vs plain: ids/flags/reverse cache "
                f"exact, Y/vel/zhat within {TOL_STEP_REL}; two kernel runs "
                f"of the step: Y " + ("bit-identical" if torch.equal(
                    y2, st_k.Y) else f"differs by {max_err(y2, st_k.Y):.3e}"))
            del st_k, st_p, stq, recq, y2
        chunk_f = funcsne.make_chunked_step(
            cfg_f, CHUNK, schedule=funcsne.default_schedule,
            n_iter=ITERS + F_ITERS)
        funcsne.funcsne_step(cfg_f, st0, X, hp_f)     # warm-up, untimed
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_f = st0
        for _ in range(F_ITERS // CHUNK):
            s_f, _ = chunk_f(s_f, X, hp)
        torch.cuda.synchronize()
        f_sps[label] = F_ITERS / (time.perf_counter() - t0)
        f_launch[label] = launches_f = dict(kernels.LAUNCHES)
        moved = {k for k, v in launches_f.items() if v > 0}
        check(moved == expect, f"{label}: launched {sorted(moved)}, "
              f"expected {sorted(expect)}")
        check(bool(torch.isfinite(s_f.Y).all()), f"{label}: Y not finite")
        rec_f = recall(s_f.hd_idx)
        check(rec_f > max(RECALL_MIN, rec_start),
              f"{label}: HD recall {rec_f}, from {rec_start} at its start")
        log(f"[f] {label}: {F_ITERS} steps at {f_sps[label]:.1f} steps/s; "
            f"launches { {k: v for k, v in launches_f.items() if v} }; HD "
            f"recall {rec_f:.4f} (from {rec_start:.4f}); Y finite")
        del s_f
    base_sps = (f_sps["default"] + f_sps["default, again"]) / 2
    log(f"[f] steps/s from the main path's final state, against the default "
        f"path before and after them ({f_sps['default']:.1f}, "
        f"{f_sps['default, again']:.1f}; the main path in (d): "
        f"{ITERS / t_run:.1f}): " + ", ".join(
            f"{k} {v:.1f} ({v / base_sps:.2f}x)" for k, v in f_sps.items()
            if not k.startswith("default")))

    # B6 at the two shapes of gather_fused=False that the paths above do not
    # record: init_state's scoring of the initial HD lists (C = k_hd) and the
    # HD refinement with c_hd_rev = 4 (C = 14)
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    c_rev = (cfg.c_hd_non + cfg.c_hd_ld + cfg.c_hd_ld_non + cfg.c_hd_rand
             + 4)
    for c_cols in (cfg.k_hd, c_rev):
        cand = st.hd_idx[:, :c_cols].contiguous()
        for x, quantised in ((Xq, True), (X, False)):
            held(f"pairwise_sqdist C={c_cols}", "pairwise_sqdist",
                 (x[ids.long()], x[cand.long()]), {}, quantised)
        log(f"[f] B6 at C = {c_cols}: exact on quantised X, relative error "
            f"within {TOL_SQDIST_REL} on the real X")
    del ids, cand

    # B5-B7 at the flag paths' shapes, on the real final state
    _, (q, c), _ = f_rec["gather_fused=False"].calls["pairwise_sqdist"]
    out_6 = torch.empty(c.shape[:2], device=dev)
    entry("pairwise_sqdist", "src/repro_torch/csrc/pairwise_sqdist.cu",
          "src/repro/kernels/pairwise_sqdist/kernel.py:47",
          lambda: pairwise_sqdist(q, c), lambda: pairwise_sqdist_ref(q, c), 10,
          nbytes(q, c, out_6), 3.0 * c.numel(), f_err["pairwise_sqdist"],
          f_launch["gather_fused=False"]["pairwise_sqdist"],
          library=lambda: torch.cdist(
              q[:, None, :], c, compute_mode="donot_use_mm_for_euclid_dist"),
          tag="[f]")
    del q, c, out_6
    b7 = [f_rec["gather_fused=False"].calls[f"ne_forces_{i}"][1:]
          for i in range(3)]
    b7_out = [ne_forces_ref(*a, **kw) for a, kw in b7]
    entry("ne_forces", "src/repro_torch/csrc/ne_forces.cu",
          "src/repro/kernels/ne_forces/kernel.py:70",
          lambda: [ne_forces(*a, **kw) for a, kw in b7],
          lambda: [ne_forces_ref(*a, **kw) for a, kw in b7], 50,
          nbytes(*[t for a, _ in b7 for t in a], *flat(tuple(
              t for o in b7_out for t in o))),
          20.0 * sum(a[2].numel() for a, _ in b7),
          max(f_err[f"ne_forces_{i}"] for i in range(3)),
          f_launch["gather_fused=False"]["ne_forces"], tag="[f]")
    log("    (B7: the three launches of one step, timed together)")
    _, (x5, q5, n5, c5, a5), kw5 = f_rec["scatter_fused=False"].calls[
        "ne_forces_gather"]
    o5 = [t for t in flat(ne_forces_gather_ref(x5, q5, n5, c5, a5, **kw5))
          if t is not None]
    entry("ne_forces_gather", "src/repro_torch/csrc/ne_forces.cu",
          "src/repro/kernels/ne_forces/kernel.py:243",
          lambda: ne_forces_gather(x5, q5, n5, c5, a5, **kw5),
          lambda: ne_forces_gather_ref(x5, q5, n5, c5, a5, **kw5), 50,
          nbytes(x5, q5, n5, c5, a5, *o5), 20.0 * n5.numel(),
          f_err["ne_forces_gather"],
          f_launch["scatter_fused=False"]["ne_forces_gather"], tag="[f]")

    def b4_entry(name, call, err, count, tag):
        """B4's time beside its bound: every input read once, every output
        written once, 3 flops per column of each row that this call's data
        makes it score (new candidates, and the current rows in rescore)."""
        _, args, kw = call
        x, qid, cur_idx, cur_d, cand = args
        ca, cv = kw.get("cand_active"), kw.get("cur_valid")
        valid = knn.dedup_candidates(qid, cur_idx, cand)
        if ca is not None:
            valid &= ca
        scored = int(valid.sum()) + (0 if cv is None else int(cv.sum()))
        outs = knn_merge_ref(*args, **kw)
        entry(name, "src/repro_torch/csrc/knn_merge.cu",
              "src/repro/kernels/knn_merge/kernel.py:173",
              lambda: knn_merge(*args, **kw), lambda: knn_merge_ref(*args, **kw),
              20, nbytes(x, qid, cur_idx, cur_d, cand, ca, cv, *outs),
              3.0 * scored * x.shape[1], err, count, tag=tag)
        log(f"    {name}: x {tuple(x.shape)} K={cur_idx.shape[1]} C="
            f"{cand.shape[1]}, {scored} rows scored "
            f"({float(valid.float().mean()):.3f} of candidates new)")

    legacy = f_rec["cand_fused=False"].calls
    for mode in ("hd", "ld"):
        b4_entry(f"knn_merge_{mode}", legacy[f"knn_merge_{mode}"],
                 f_err[f"knn_merge_{mode}"],
                 f_launch["cand_fused=False"][f"knn_merge_{mode}"], "[f]")

    # what the threefry draws of one cand_fused=False step cost on the card:
    # the host key chain and gate, the HD candidates (behind the gate), the
    # LD candidates and the negatives
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    p_h = torch.tensor(0.5)

    def chain():
        k = threefry.fold_in(st.rng.cpu(), int(st.step))
        r4 = threefry.split(k, 4)
        bool(threefry.bernoulli(r4[0], p_h))
        return r4

    r4 = chain()

    def hd_draws():
        r = threefry.split(r4[1], 5)
        return (knn.sample_hops(r[0], st.hd_idx, st.hd_idx, ids, cfg.c_hd_non),
                knn.sample_direct(r[1], st.ld_idx, cfg.c_hd_ld),
                knn.sample_hops(r[2], st.ld_idx, st.ld_idx, ids,
                                cfg.c_hd_ld_non),
                knn.sample_uniform(r[3], N, N, cfg.c_hd_rand, device=dev))

    def ld_neg_draws():
        r = threefry.split(r4[2], 3)
        return (knn.sample_hops(r[0], st.ld_idx, st.ld_idx, ids, cfg.c_ld_non),
                knn.sample_direct(r[1], st.hd_idx, cfg.c_ld_hd),
                knn.sample_uniform(r[2], N, N, cfg.c_ld_rand, device=dev),
                knn.sample_uniform(r4[3], N, N, cfg.n_negatives, device=dev))
    draw_ms = {"key chain + gate (host)": wall_ms(chain),
               "HD candidates": wall_ms(hd_draws),
               "LD candidates + negatives": wall_ms(ld_neg_draws)}
    gate_share = f_launch["cand_fused=False"]["knn_merge_hd"] / F_ITERS
    per_step = (draw_ms["key chain + gate (host)"]
                + gate_share * draw_ms["HD candidates"]
                + draw_ms["LD candidates + negatives"])
    log("[f] threefry draws of a cand_fused=False step (wall ms, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in draw_ms.items())
        + f"; {per_step:.3f} ms per step with the gate firing on "
        f"{gate_share:.2f} of steps")

    # ---- (g) nearest-neighbour descent ------------------------------------
    ncfg = nnd.NNDConfig()
    nkey = threefry.prng_key(0)
    r0 = threefry.fold_in(nkey, 0)
    recq, recr = Recorder(funcsne), Recorder(funcsne)
    idx_q, d_q = nnd.nnd_init(nkey, Xq, ncfg, device=dev, ops=recq.ops)
    nnd.nnd_step(r0, Xq, idx_q, d_q, ncfg, device=dev, ops=recq.ops)
    idx_r, d_r = nnd.nnd_init(nkey, X, ncfg, device=dev, ops=recr.ops)
    nnd.nnd_step(r0, X, idx_r, d_r, ncfg, device=dev, ops=recr.ops)
    check(set(recq.calls) == {"pairwise_sqdist_gather_hd", "knn_merge_hd"},
          f"NND calls {set(recq.calls)}")
    for key, call in recq.calls.items():
        held(key, *call, True)
    g_err = held("knn_merge_hd", *recr.calls["knn_merge_hd"], False)
    out_k = nnd.nnd_step(r0, Xq, idx_q, d_q, ncfg, device=dev,
                         ops=funcsne.KERNELS)
    out_p = nnd.nnd_step(r0, Xq, idx_q, d_q, ncfg, device=dev,
                         ops=funcsne.PLAIN)
    for g, w, name in zip(out_k, out_p, ("idx", "d", "update fraction")):
        check(torch.equal(g, w), f"NND step {name} differs, kernels vs plain")
    log(f"[g] NND: B1 (C = {ncfg.k}) and B4 (C = "
        f"{recq.calls['knn_merge_hd'][1][4].shape[1]}) exact on quantised X, "
        f"B4 distances within {TOL_SQDIST_REL} on the real X; one iteration "
        f"kernels vs plain: idx/d/update fraction exact (fraction "
        f"{float(out_k[2]):.4f})")
    del out_k, out_p, idx_q, d_q, recq

    idx_s, _, hist_s = nnd.nnd(X, ncfg, nkey, max_iter=NND_SHORT, tol=1e-3,
                               device=dev)
    rec_s = recall(idx_s)
    del idx_s
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx_n, _, hist = nnd.nnd(X, ncfg, nkey, max_iter=NND_ITERS, tol=1e-3,
                             device=dev)
    torch.cuda.synchronize()
    t_nnd = time.perf_counter() - t0
    launches_g = dict(kernels.LAUNCHES)
    want_g = {"pairwise_sqdist_gather": 1, "knn_merge_hd": len(hist)}
    check(launches_g == {k: want_g.get(k, 0) for k in launches_g},
          f"NND launches {launches_g}, expected {want_g}")
    check(hist[-1] < hist[0], f"NND update fraction did not fall: {hist}")
    check(hist[:len(hist_s)] == hist_s, "NND histories of one key differ")
    rec_g = recall(idx_n)
    check(rec_g > RECALL_MIN, f"NND recall {rec_g} <= {RECALL_MIN}")
    log(f"[g] NND: {len(hist)} iterations in {t_nnd:.2f}s = "
        f"{len(hist) / t_nnd:.1f} iterations/s (init included); launches "
        f"{ {k: v for k, v in launches_g.items() if v} }; HD recall@{ncfg.k} "
        f"{rec_g:.4f} on the same {RECALL_ROWS} rows ({rec_s:.4f} after "
        f"{len(hist_s)} iterations; FUnc-SNE after {ITERS} steps: "
        f"{rec1:.4f}); update fractions "
        + " ".join(f"{h:.4f}" for h in hist))
    b4_entry("knn_merge_nnd", recr.calls["knn_merge_hd"], g_err,
             launches_g["knn_merge_hd"], "[g]")
    log(f"    total {time.perf_counter() - t_start:.1f}s")

    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
