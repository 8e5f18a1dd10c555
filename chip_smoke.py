#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Drives the port's main path (``repro_torch``: ``init_state`` and the chunk
runner with ``default_schedule``, the single-device route of
``python -m repro_torch.launch.embed``) at MNIST's shape, n = 70,000 and
dim_hd = 784, on an MNIST-shaped synthetic dataset, then the paths of the
later slices (flag paths, NND, the MusicGen-large latents pipeline), and
checks them:

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

  (h) B8, causal GQA flash attention, alone: MusicGen-large's prefill shape
      (B 4, S 1500, 32 heads of 64, bf16), Gemma2-2b's (B 1, S 8192, 8
      query and 4 KV heads of 256, softcap 50) with window 4096 and 0, and
      a float32 case, each against its plain version (TOL_ATTN_F32, one
      bf16 ulp), timed beside its bound and, without softcap or window,
      ``F.scaled_dot_product_attention`` as the yardstick;
  (i) the latents pipeline of ``repro_torch.examples.embed_latents`` with
      MusicGen-large at full width and depth (48 layers, d_model 2048,
      float32 params from ``init_params(0)`` by threefry on the card, bf16
      compute): one batch of 64 through B8 against one through the plain
      ``flash_chunked`` (TOL_LATENTS), B8 at that path's shape, then with
      the launch counters set to 0 the forward over N_SEQ sequences of 24
      frames (B8 48 times a batch, nothing else; tokens/s), PCA 16; the
      fit's B1, B2 and B3 at its shapes (dim_hd 16, dim_ld 8) from
      init_state and one step against their plain versions, and one step
      kernels vs plain; then with the counters at 0 ``fit`` with dim_ld 8
      over 500 steps (steps/s) and one-shot 1-NN on the latents, pca16 and
      funcsne8 (funcsne8 >= ACC_MIN);
  (j) the repairs: C1, embedding widths C1_WIDTHS on the same X (B1-B3, B5
      and B7 against their plain versions, one step kernels vs plain, a
      50-step chunk on the kernels equal to its steps one by one, and
      where those steps part from the plain versions' (reported)), and B2
      and B4 at K = 128, C = 64 from one step of such a config; each row's
      launches counted over a step or chunk of its own path and shape; C3,
      two runs of one step and of F_ITERS
      steps of ``scatter_fused=False`` and ``gather_fused=False`` from one
      state bit-identical; C2, ``fit(snapshot_every=100)`` returns 5
      snapshots, the last the returned Y, and a state equal to (d)'s.

Phase (b) also holds threefry's draws made on the card (randint at
(70,000, 10) with spans 70,000 and 32, bernoulli, a fold_in/split chain)
against the same draws made on the CPU, bit for bit.  Phase (f) also
holds the segment sum of the unfused paths' symmetrisation bit for bit
to the CPU's sequential ``index_add_``.  bf16 matmuls run with fp32
reductions throughout (``allow_bf16_reduced_precision_reduction`` off),
float32 ones in full float32 (TF32 off).

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
BF16_FLOPS_PER_S = 989e12      # H100 SXM, bf16 tensor cores, dense
# tolerances of the float comparisons, kernel vs plain version on the card
TOL_SQDIST_REL = 1e-5          # sum over 784 columns in another order
TOL_FORCE_REL = 1e-5           # of each field's largest entry
TOL_STEP_REL = 1e-4            # Y / vel / zhat after one step
# B8 against its plain version: float32 within TOL_ATTN_F32 of the largest
# |out| (the same float32 arithmetic summed in another order); bfloat16
# within one bf16 ulp of the larger of the two values (both round an fp32
# result to bf16, and two fp32 results 1e-7 apart can round to neighbours)
# plus that float32 tolerance
TOL_ATTN_F32 = 1e-5
# (name, B, Hq, Hkv, S, D, dtype, softcap, window, timing reps) of phase (h):
# MusicGen-large's prefill of 30 s of 50 Hz frames, Gemma2-2b's local and
# global layers at 8k, and a float32 case
ATTN_CASES = (
    ("flash_attention_musicgen", 4, 32, 32, 1500, 64, torch.bfloat16, 0.0, 0,
     20),
    ("flash_attention_gemma2_w4096", 1, 8, 4, 8192, 256, torch.bfloat16, 50.0,
     4096, 5),
    ("flash_attention_gemma2_w0", 1, 8, 4, 8192, 256, torch.bfloat16, 50.0, 0,
     5),
    ("flash_attention_fp32", 4, 32, 32, 1500, 64, torch.float32, 0.0, 0, 20),
)
# phase (i): sequences of 24 frames through MusicGen-large (98,304 tokens)
N_SEQ = 4096
# hidden states and pooled latents of one batch, B8 against the plain
# flash_chunked in all 48 layers, relative Frobenius error: bf16 compute
# rounds each layer's residual stream (2^-8 relative), and a 1-ulp
# difference in an attention output propagates through 48 layers
TOL_LATENTS = 5e-2
ACC_MIN = 0.95                 # one-shot 1-NN of the 8-D embedding
# phase (j), C1: embedding widths beyond the templated d = 1..4: 5 runs the
# runtime-width path, 8 (the latents pipeline) and 32 (the dry run's
# embed_1m) the compile-time widths
C1_WIDTHS = (5, 8, 32)


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


def bound(bytes_, flops, peak=None):
    """The larger of bytes / HBM rate and flops / ``peak`` (default the
    float32 rate outside the tensor cores), in ms."""
    peak = FP32_FLOPS_PER_S if peak is None else peak
    tb, tf = bytes_ / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def attn_close(got, want, name):
    """Check B8's output against its plain version (see TOL_ATTN_F32);
    returns the max abs error."""
    g, w = got.float(), want.float()
    tol = TOL_ATTN_F32 * float(w.abs().max())
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
    err = (g - w).abs()
    check(got.dtype == want.dtype and bool((err <= tol).all()),
          f"{name}: max abs err {float(err.max())}")
    return float(err.max())


def attn_pairs(s_len, window):
    """(row, col) pairs a causal (windowed) attention of length s_len
    computes: sum over rows of min(row + 1, window)."""
    if not window or window >= s_len:
        return s_len * (s_len + 1) // 2
    return window * (window + 1) // 2 + (s_len - window) * window


class Recorder:
    """Ops that record each call as (entry point, args, kw), then run the
    kernel.

    Calls are keyed by the entry point's name, with _hd / _ld for B1, B2
    and B4 (B1's LD calls are those on ``dim_ld`` columns) and the call's
    index for B7 (three calls a step)."""

    def __init__(self, funcsne, dim_ld=2):
        self.calls = {}
        n_b7 = [0]

        def rec(name, fn):
            def f(*args, **kw):
                key = name
                if name in ("knn_merge_cand", "knn_merge"):
                    key += "_ld" if args[3] is None else "_hd"
                elif name == "pairwise_sqdist_gather":
                    key += "_ld" if args[0].shape[1] == dim_ld else "_hd"
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
    from repro_torch.kernels.segment_sum.ops import segment_runs, segment_sum
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.knn_merge.ops import MAX_C, MAX_K
    from repro_torch.configs.base import get_arch
    from repro_torch.examples import embed_latents
    from repro_torch.models.attention import flash_chunked, flash_chunked_ref
    from repro_torch.models.transformer import LMModel
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 matmuls accumulate in fp32 throughout, as XLA's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
        st, _, metrics = chunk(st, X, hp)
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
              count, library=None, tag="[e]", peak=None):
        ms = time_ms(fn, reps)
        plain_ms = time_ms(plain, max(2, reps // 10))
        lib_ms = None if library is None else time_ms(library,
                                                      max(2, reps // 10))
        b_ms, b_by = bound(bytes_, flops, peak)
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

    def b2_entry(name, call, err, count, tag):
        """B2's time beside its bound: every input read once, every output
        written once, 3 flops per column of each row that this call's data
        makes it score (new candidates, and the current rows in rescore)."""
        _, args, kw = call
        x, qid, cur_idx, cur_d = args
        c_cand = knn.counter_candidates(kw["salt"], qid, kw["sources"],
                                        kw["first_tables"],
                                        kw["second_tables"],
                                        n_total=x.shape[0])
        valid = knn.dedup_candidates(qid, cur_idx, c_cand)
        if kw.get("active") is not None:
            valid &= kw["active"][c_cand.long().clamp(0, x.shape[0] - 1)]
        scored = int(valid.sum()) + (int(kw["cur_valid"].sum())
                                     if cur_d is None else 0)
        outs = knn_merge_cand_ref(*args, **kw)
        entry(name, "src/repro_torch/csrc/knn_merge.cu",
              "src/repro/kernels/knn_merge/kernel.py:507",
              lambda: knn_merge_cand(*args, **kw),
              lambda: knn_merge_cand_ref(*args, **kw), 20,
              nbytes(x, qid, cur_idx, cur_d, kw["salt"], kw.get("active"),
                     kw.get("cur_valid"), *kw["first_tables"],
                     *kw["second_tables"], *outs),
              3.0 * scored * x.shape[1], err, count, tag=tag)
        log(f"    {name}: x {tuple(x.shape)} K={cur_idx.shape[1]} C="
            f"{c_cand.shape[1]}, {scored} rows scored "
            f"({valid.float().mean():.3f} of candidates new)")

    rec = Recorder(funcsne)
    base = knn.key_salt(st.rng)
    st_t = funcsne._hd_refine(cfg, st, X, base, rec.ops)
    funcsne._ld_refine(cfg, st_t, base, rec.ops)
    funcsne._forces_update(cfg, st_t, hp, base, rec.ops)
    for mode in ("hd", "ld"):
        b2_entry(f"knn_merge_cand_{mode}", rec.calls[f"knn_merge_cand_{mode}"],
                 errs[f"knn_merge_cand_{mode}"],
                 launches[f"knn_merge_cand_{mode}"], "[e]")

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
                               {"pairwise_sqdist", "ne_forces",
                                "segment_sum"}),
        "scatter_fused=False": (dict(scatter_fused=False),
                                b2 | {"ne_forces_gather", "segment_sum"}),
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
        abs error.  The scoring kernels exact on quantised inputs, their
        distances within TOL_SQDIST_REL on real ones (ids and flags may
        part at a near tie there); forces within TOL_FORCE_REL."""
        got = flat(getattr(funcsne.KERNELS, op)(*args, **kw))
        want = flat(getattr(funcsne.PLAIN, op)(*args, **kw))
        err = 0.0
        for g, w in zip(got, want):
            check((g is None) == (w is None), f"{key}: None outputs differ")
            if w is None:
                continue
            if op in exact_ops and quantised:
                check(torch.equal(g, w), f"{key} not exact on quantised input")
            elif op in ("knn_merge", "knn_merge_cand") \
                    and w.dtype == torch.float32:
                # distances; on the real X a near tie may swap two ids
                fin = torch.isfinite(w)
                check(torch.equal(torch.isfinite(g), fin),
                      f"{key}: +inf slots differ")
                rel = float(((g[fin] - w[fin]).abs()
                             / w[fin].abs().clamp_min(1.0)).max())
                check(rel <= TOL_SQDIST_REL, f"{key} relative error {rel}")
            elif op in ("pairwise_sqdist", "pairwise_sqdist_gather"):
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
            # every path is deterministic on the card since the unfused
            # paths' symmetrisation is a segment sum in a fixed order
            y2 = funcsne.funcsne_step(cfg_f, stq, Xq, hp_f,
                                      ops=funcsne.KERNELS).Y
            check(torch.equal(y2, st_k.Y),
                  f"{label}: two kernel runs of one step differ by "
                  f"{max_err(y2, st_k.Y):.3e}")
            log(f"    one step, kernels vs plain: ids/flags/reverse cache "
                f"exact, Y/vel/zhat within {TOL_STEP_REL}; two kernel runs "
                f"of the step: Y bit-identical")
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
            s_f, _, _ = chunk_f(s_f, X, hp)
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

    _, (ix, vx, nx), _ = f_rec["scatter_fused=False"].calls["segment_sum"]
    out_s = torch.empty((nx, vx.shape[1]), device=dev)
    entry("segment_sum", "src/repro_torch/csrc/segment_sum.cu",
          "src/repro/core/funcsne.py:732",
          lambda: segment_sum(ix, vx, nx), lambda: segment_sum_ref(ix, vx, nx),
          50, nbytes(ix, vx, out_s), 1.0 * vx.numel(), f_err["segment_sum"],
          f_launch["scatter_fused=False"]["segment_sum"],
          library=lambda: torch.zeros_like(out_s).index_add_(0, ix, vx),
          tag="[f]")
    check(torch.equal(segment_sum(ix, vx, nx).cpu(),
                      segment_sum_ref(ix.cpu(), vx.cpu(), nx)),
          "segment_sum differs from the sequential index_add_ on the CPU")
    # how its time splits: the wrapper's stable sort and segment offsets
    # alone, the rest is the kernel's fixed-order walk
    sort_ms = time_ms(lambda: segment_runs(ix, nx), 50)
    log(f"    segment_sum: {ix.shape[0]} rows of {vx.shape[1]} into {nx}; "
        f"bit-identical to the CPU's sequential index_add_; its sort and "
        f"offsets alone take {sort_ms:.4f} ms of its {out[-1]['ms']:.4f} ms")
    del out_s

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

    # ---- (h) B8 alone ------------------------------------------------------
    b8 = {}
    gen = torch.Generator(device=dev).manual_seed(7)
    for name, b, hq, hkv, s_len, d_h, dt, cap, win, reps in ATTN_CASES:
        q, k, v = (torch.randn((b, h, s_len, d_h), generator=gen, device=dev)
                   .to(dt) for h in (hq, hkv, hkv))
        got = flash_attention(q, k, v, softcap=cap, window=win)
        want = flash_attention_ref(q, k, v, softcap=cap, window=win)
        err = attn_close(got, want, name)
        lib = None
        if not cap and not win:
            lib = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        entry(name, "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:86",
              lambda q=q, k=k, v=v, cap=cap, win=win: flash_attention(
                  q, k, v, softcap=cap, window=win),
              lambda q=q, k=k, v=v, cap=cap, win=win: flash_attention_ref(
                  q, k, v, softcap=cap, window=win),
              reps, nbytes(q, k, v, got),
              4.0 * b * hq * d_h * attn_pairs(s_len, win), err, 0,
              library=lib, tag="[h]",
              peak=BF16_FLOPS_PER_S if dt == torch.bfloat16
              else FP32_FLOPS_PER_S)
        b8[name] = out[-1]
        log(f"    {name}: B {b}, S {s_len}, Hq {hq}, Hkv {hkv}, D {d_h}, "
            f"{str(dt)[6:]}, softcap {cap}, window {win}: max abs err "
            f"{err:.3e} against the plain version")
        del q, k, v, got, want
    torch.cuda.empty_cache()

    # ---- (i) MusicGen-large's hidden states into an 8-D FUnc-SNE ------------
    cfg_m = get_arch("musicgen-large")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LMModel(cfg_m)
    params = model.init_params(0, device=dev)
    torch.cuda.synchronize()
    t_minit = time.perf_counter() - t0
    n_par = sum(t.numel() for blk in params["blocks"] for grp in blk.values()
                for t in (grp.values() if isinstance(grp, dict) else (grp,)))
    n_par += sum(t.numel() for key, t in params.items() if key != "blocks")
    frames, labels = embed_latents.make_frames(N_SEQ, cfg_m.d_model)
    log(f"[i] {cfg_m.name}: {cfg_m.n_layers} layers, d_model "
        f"{cfg_m.d_model}, {cfg_m.n_heads} heads of "
        f"{cfg_m.resolved_head_dim}, d_ff {cfg_m.d_ff}, {cfg_m.param_dtype} "
        f"params ({n_par / 1e9:.3f} B, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), "
        f"{cfg_m.compute_dtype} compute; init_params(0) by threefry on the "
        f"card in {t_minit:.1f}s; frames {frames.shape}")
    calls = []

    def rec_attn(q, k, v, **kw):
        if not calls:
            calls.append((q, k, v, kw))
        return flash_chunked(q, k, v, **kw)
    x0 = torch.from_numpy(frames[:embed_latents.BATCH]).to(dev)
    h_k = LMModel(cfg_m, attention=rec_attn).hidden_states(params, x0)
    h_p = LMModel(cfg_m, attention=flash_chunked_ref).hidden_states(params, x0)
    rel_h = float((h_k.float() - h_p.float()).norm() / h_p.float().norm())
    pk, pp = h_k.float().mean(dim=1), h_p.float().mean(dim=1)
    rel_pool = float((pk - pp).norm() / pp.norm())
    log(f"[i] one batch of {x0.shape[0]} x {x0.shape[1]} frames, B8 against "
        f"the plain flash_chunked in all {cfg_m.n_layers} layers: hidden "
        f"states differ by {rel_h:.3e} (relative Frobenius), pooled latents "
        f"by {rel_pool:.3e}, largest entry {max_err(h_k, h_p):.3e} "
        f"(tol {TOL_LATENTS})")
    check(rel_h <= TOL_LATENTS and rel_pool <= TOL_LATENTS,
          f"latents, kernels vs plain: {rel_h}, {rel_pool}")
    q, k, v, kw = calls[0]
    err = attn_close(flash_chunked(q, k, v, **kw),
                     flash_chunked_ref(q, k, v, **kw), "B8 at the latents shape")
    b_, s_, hq_, d_ = q.shape
    entry("flash_attention_latents", "src/repro_torch/csrc/flash_attention.cu",
          "src/repro/kernels/flash_attention/kernel.py:86",
          lambda: flash_chunked(q, k, v, **kw),
          lambda: flash_chunked_ref(q, k, v, **kw), 50,
          nbytes(q, k, v) + q.numel() * q.element_size(),
          4.0 * b_ * hq_ * d_ * attn_pairs(s_, 0), err, 0,
          library=lambda: F.scaled_dot_product_attention(
              q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              is_causal=True, enable_gqa=True), tag="[i]",
          peak=BF16_FLOPS_PER_S)
    b8["flash_attention_latents"] = out[-1]
    log(f"    (layer 0's call: q, k, v {tuple(q.shape)} in the (B, S, H, D) "
        f"layout, strides {q.stride()}; max abs err {err:.3e})")
    del h_k, h_p, x0, calls, q, k, v

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H = embed_latents.latents(model, params, frames, dev)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    launches_i = dict(kernels.LAUNCHES)
    n_batches = -(-N_SEQ // embed_latents.BATCH)
    want_i = {"flash_attention": cfg_m.n_layers * n_batches}
    check(launches_i == {k_: want_i.get(k_, 0) for k_ in launches_i},
          f"forward launches {launches_i}, expected {want_i}")
    check(H.shape == (N_SEQ, cfg_m.d_model) and bool(torch.isfinite(H).all()),
          "latents not finite")
    for row in b8.values():
        row["launches"] = launches_i["flash_attention"]
    # where a batch's time goes: device time by kernel over two batches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        embed_latents.latents(model, params,
                              frames[:2 * embed_latents.BATCH], dev)
        torch.cuda.synchronize()
    rows_i = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_i = sum(r[1] for r in rows_i) / 2
    log(f"[i] profiler, 2 batches: device busy {busy_i:.2f} ms per batch "
        f"against {t_fwd / n_batches * 1e3:.2f} ms of wall time per batch "
        f"unprofiled; device time by kernel:")
    for key, ms, cnt in sorted(rows_i, key=lambda r: -r[1])[:8]:
        log(f"    {ms:9.3f} ms  {cnt:5d}x  {key[:90]}")
    del prof, rows_i
    n_tok = N_SEQ * embed_latents.SEQ
    log(f"[i] forward: {N_SEQ} sequences x {embed_latents.SEQ} frames "
        f"({n_tok} tokens) in {n_batches} batches: {t_fwd:.2f}s = "
        f"{n_tok / t_fwd:.0f} tokens/s; B8 launched "
        f"{launches_i['flash_attention']} times ({cfg_m.n_layers} per "
        f"batch), nothing else; latents finite")
    del params, model, frames
    torch.cuda.empty_cache()

    # the 8-D fit's kernels at its shapes: init_state and one step of its
    # config on the PCA-16 latents through recording ops, once on an
    # integer grid (Hp scaled to |x| <= 64, Y to a quarter grid; distances
    # exact) and once as they are
    Hp = embed_latents.project(H)
    cfg_ne, hp_ne = embed_latents.ne_config(N_SEQ, dev)
    Hq = torch.round(Hp * (64.0 / float(Hp.abs().max())))
    recq, recr = (Recorder(funcsne, cfg_ne.dim_ld) for _ in range(2))
    st_q = funcsne.init_state(Hq, cfg_ne, seed=0, perplexity=hp_ne.perplexity,
                              device=dev, ops=recq.ops)
    st_q = st_q._replace(Y=torch.round(st_q.Y * (256.0 / float(
        st_q.Y.abs().max()))) / 4.0)
    funcsne.funcsne_step(cfg_ne, st_q, Hq, hp_ne, ops=recq.ops)
    st_r = funcsne.init_state(Hp, cfg_ne, seed=0, perplexity=hp_ne.perplexity,
                              device=dev, ops=recr.ops)
    funcsne.funcsne_step(cfg_ne, st_r, Hp, hp_ne, ops=recr.ops)
    want_calls = {"pairwise_sqdist_gather_hd", "pairwise_sqdist_gather_ld",
                  "knn_merge_cand_hd", "knn_merge_cand_ld", "ne_forces_scatter"}
    check(set(recq.calls) == want_calls == set(recr.calls),
          f"latents fit calls {set(recq.calls)}, {set(recr.calls)}")
    i_err = {}
    for key, (op, args, kw) in recq.calls.items():
        if key == "pairwise_sqdist_gather_ld":   # the Y it scored: on the grid
            args = (st_q.Y, *args[1:])
        held(key, op, args, kw, True)
    for key, call in recr.calls.items():
        i_err[key] = held(key, *call, False)
    st_k = funcsne.funcsne_step(cfg_ne, st_q, Hq, hp_ne, ops=funcsne.KERNELS)
    st_p = funcsne.funcsne_step(cfg_ne, st_q, Hq, hp_ne, ops=funcsne.PLAIN)
    for name in ("hd_idx", "hd_d", "ld_idx", "new_flag", "step",
                 "ema_new_frac"):
        check(torch.equal(getattr(st_k, name), getattr(st_p, name)),
              f"latents fit step {name} differs")
    for name in ("Y", "vel", "zhat"):
        a, b = getattr(st_k, name), getattr(st_p, name)
        check(max_err(a, b) <= TOL_STEP_REL * float(b.abs().max()),
              f"latents fit step {name}: err {max_err(a, b)}")
    log(f"[i] the fit's kernels at its shapes (n {N_SEQ}, dim_hd "
        f"{cfg_ne.dim_hd}, dim_ld {cfg_ne.dim_ld}): B1 HD/LD, B2 HD/LD and B3 "
        f"from init_state and one step, against their plain versions: "
        f"exact on the integer grid; on the real latents max abs err "
        + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in sorted(i_err.items()))
        + f" (distances within {TOL_SQDIST_REL}, forces within "
        f"{TOL_FORCE_REL} relative); one step kernels vs plain: ids/flags "
        f"exact, Y/vel/zhat within {TOL_STEP_REL}")
    del Hp, Hq, recq, recr, st_q, st_r, st_k, st_p

    kernels.reset_launches()
    acc, st_l, fit_s = embed_latents.embed_and_score(H, labels, dev)
    launches_l = dict(kernels.LAUNCHES)
    moved = {k_ for k_, v_ in launches_l.items() if v_}
    check(moved == main_kernels, f"fit launched {sorted(moved)}")
    check(bool(torch.isfinite(st_l.Y).all()), "8-D embedding not finite")
    log(f"[i] PCA 16 -> fit(dim_ld=8, n_iter=500): {500 / fit_s:.1f} steps/s "
        f"(init included); launches { {k_: v_ for k_, v_ in launches_l.items() if v_} }; "
        "one-shot 1-NN over 5 trials: "
        + ", ".join(f"{k_} {v_:.3f}" for k_, v_ in acc.items()))
    check(acc["funcsne8"] >= ACC_MIN, f"funcsne8 accuracy {acc['funcsne8']}")
    del H, st_l

    # ---- (j) the repairs: width (C1), snapshots (C2), determinism (C3) ------
    for d_ld in C1_WIDTHS:
        cfg_w = dataclasses.replace(cfg, dim_ld=d_ld)
        stq = funcsne.init_state(Xq, cfg_w, seed=1, device=dev)
        stq = stq._replace(Y=torch.round(stq.Y * 400.0) / 4.0)
        for flags in ({}, dict(scatter_fused=False), dict(gather_fused=False)):
            recw = Recorder(funcsne, d_ld)
            funcsne.funcsne_step(dataclasses.replace(cfg_w, **flags), stq, Xq,
                                 hp, ops=recw.ops)
            for key, call in recw.calls.items():
                held(key, *call, True)
        st_k = funcsne.funcsne_step(cfg_w, stq, Xq, hp, ops=funcsne.KERNELS)
        st_p = funcsne.funcsne_step(cfg_w, stq, Xq, hp, ops=funcsne.PLAIN)
        for name in ("hd_idx", "hd_d", "ld_idx", "new_flag", "ema_new_frac"):
            check(torch.equal(getattr(st_k, name), getattr(st_p, name)),
                  f"d={d_ld} step {name} differs")
        for name in ("Y", "vel", "zhat"):
            a, b = getattr(st_k, name), getattr(st_p, name)
            check(max_err(a, b) <= TOL_STEP_REL * float(b.abs().max()),
                  f"d={d_ld} step {name}: err {max_err(a, b)}")
        log(f"[j] C1 dim_ld {d_ld}: B1-B3, B5 and B7 against their plain "
            f"versions at this width (scoring exact on quantised inputs); "
            f"one step kernels vs plain: ids/flags exact, Y/vel/zhat within "
            f"{TOL_STEP_REL}")
        del stq, st_k, st_p
        st_w = funcsne.init_state(X, cfg_w, seed=0, perplexity=hp.perplexity,
                                  device=dev)
        chunk_w = funcsne.make_chunked_step(
            cfg_w, CHUNK, schedule=funcsne.default_schedule, n_iter=ITERS)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_k, _, _ = chunk_w(st_w, X, hp)
        torch.cuda.synchronize()
        sps_w = CHUNK / (time.perf_counter() - t0)
        launches_w = dict(kernels.LAUNCHES)
        moved = {k_ for k_, v_ in launches_w.items() if v_}
        check(moved == main_kernels - {"pairwise_sqdist_gather"},
              f"d={d_ld} chunk launched {sorted(moved)}")
        check(bool(torch.isfinite(s_k.Y).all()), f"d={d_ld}: Y not finite")
        # the chunk's steps one at a time through the kernels (the chunk
        # must be exactly its steps) and through the plain versions
        # (reported: where the two part, and how far)
        s_a = s_p = st_w
        first_id, y_err = None, {}
        for i in range(1, CHUNK + 1):
            s_a = funcsne.funcsne_step(
                cfg_w, s_a, X, funcsne.default_schedule(s_a.step, ITERS, hp))
            s_p = funcsne.funcsne_step(
                cfg_w, s_p, X, funcsne.default_schedule(s_p.step, ITERS, hp),
                ops=funcsne.PLAIN)
            if first_id is None and not (torch.equal(s_a.hd_idx, s_p.hd_idx)
                                         and torch.equal(s_a.ld_idx,
                                                         s_p.ld_idx)):
                first_id = i
            if i in (1, 5, 10, 25, CHUNK):
                y_err[i] = max_err(s_a.Y, s_p.Y) / float(s_p.Y.abs().max())
        check(all(torch.equal(getattr(s_a, f), getattr(s_k, f))
                  for f in funcsne.FuncSNEState._fields),
              f"d={d_ld}: the chunk differs from its steps")
        same_hd = float((s_a.hd_idx == s_p.hd_idx).all(1).float().mean())
        log(f"[j] C1 dim_ld {d_ld}: a {CHUNK}-step chunk on the kernels at "
            f"{sps_w:.1f} steps/s, launches "
            f"{ {k_: v_ for k_, v_ in launches_w.items() if v_} }, Y finite, "
            f"equal to its steps run one by one; against the plain versions "
            f"step by step (reported): ids first differ after step "
            f"{first_id}, Y error of max|Y| "
            + ", ".join(f"{e:.2e} after {i}" for i, e in y_err.items())
            + f"; rows with equal HD lists after {CHUNK}: {same_hd:.4f}")
        del s_p, s_a
        # the kernels at this width, on the real state: one step of each
        # path with the launch counters set to 0 just before
        recs, recs_launch = {}, {}
        for flags in ({}, dict(scatter_fused=False), dict(gather_fused=False)):
            recs[tuple(flags)] = Recorder(funcsne, d_ld)
            kernels.reset_launches()
            funcsne.funcsne_step(dataclasses.replace(cfg_w, **flags),
                                 forced(s_k), X, hp, ops=recs[tuple(flags)].ops)
            recs_launch[tuple(flags)] = dict(kernels.LAUNCHES)
        _, (y, qid, nbr, coef, alpha), kw = recs[()].calls["ne_forces_scatter"]
        o3 = ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw)
        entry(f"ne_forces_scatter_d{d_ld}", "src/repro_torch/csrc/ne_forces.cu",
              "src/repro/kernels/ne_forces/kernel.py:451",
              lambda: ne_forces_scatter(y, qid, nbr, coef, alpha, **kw),
              lambda: ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw),
              20, nbytes(y, qid, nbr, coef, alpha, *o3[0], *o3[1]),
              (12.0 + 4.0 * d_ld) * nbr.numel(),
              held("B3", *recs[()].calls["ne_forces_scatter"], False),
              launches_w["ne_forces_scatter"], tag="[j]")
        _, (x5, q5, n5, c5, a5), kw5 = recs[("scatter_fused",)].calls[
            "ne_forces_gather"]
        o5 = [t for t in flat(ne_forces_gather_ref(x5, q5, n5, c5, a5, **kw5))
              if t is not None]
        entry(f"ne_forces_gather_d{d_ld}", "src/repro_torch/csrc/ne_forces.cu",
              "src/repro/kernels/ne_forces/kernel.py:243",
              lambda: ne_forces_gather(x5, q5, n5, c5, a5, **kw5),
              lambda: ne_forces_gather_ref(x5, q5, n5, c5, a5, **kw5), 20,
              nbytes(x5, q5, n5, c5, a5, *o5), (12.0 + 4.0 * d_ld) * n5.numel(),
              held("B5", *recs[("scatter_fused",)].calls["ne_forces_gather"],
                   False),
              recs_launch[("scatter_fused",)]["ne_forces_gather"], tag="[j]")
        b7w = [recs[("gather_fused",)].calls[f"ne_forces_{i}"][1:]
               for i in range(3)]
        o7 = [ne_forces_ref(*a, **kw_) for a, kw_ in b7w]
        entry(f"ne_forces_d{d_ld}", "src/repro_torch/csrc/ne_forces.cu",
              "src/repro/kernels/ne_forces/kernel.py:70",
              lambda: [ne_forces(*a, **kw_) for a, kw_ in b7w],
              lambda: [ne_forces_ref(*a, **kw_) for a, kw_ in b7w], 20,
              nbytes(*[t for a, _ in b7w for t in a],
                     *flat(tuple(t for o in o7 for t in o))),
              (12.0 + 4.0 * d_ld) * sum(a[2].numel() for a, _ in b7w),
              max(held("B7", "ne_forces", a, kw_, False) for a, kw_ in b7w),
              recs_launch[("gather_fused",)]["ne_forces"], tag="[j]")
        log(f"    (at dim_ld {d_ld}, a "
            + ("runtime width in tiles of 4" if d_ld not in (8, 16, 32)
               else "compile-time width")
            + f": B3 launches over the {CHUNK}-step chunk; B5 and B7 over "
            f"one step of their paths, B7's three timed together)")
        del st_w, s_k, recs, o3, o5, o7, b7w

    # B2 and B4 at K = 128, C = 64: init_state and one step of a config with
    # those list sizes (58 two-hop HD candidates), for the candidate-fused
    # path and for cand_fused=False; held on the quantised X, timed and
    # counted on the real X with the launch counters set to 0 just before
    cfg_k = dataclasses.replace(cfg, k_hd=128, c_hd_non=58)
    c_k = (cfg_k.c_hd_non + cfg_k.c_hd_ld + cfg_k.c_hd_ld_non
           + cfg_k.c_hd_rand)
    for flags, op in (({}, "knn_merge_cand"),
                      (dict(cand_fused=False), "knn_merge")):
        cfg_kf = dataclasses.replace(cfg_k, **flags)
        recq, recr = Recorder(funcsne), Recorder(funcsne)
        s_q = funcsne.init_state(Xq, cfg_kf, seed=1, device=dev)
        funcsne.funcsne_step(cfg_kf, s_q, Xq, hp, ops=recq.ops)
        held(f"{op} K=128 C={c_k}", *recq.calls[f"{op}_hd"], True)
        s_r = funcsne.init_state(X, cfg_kf, seed=0, perplexity=hp.perplexity,
                                 device=dev)
        kernels.reset_launches()
        funcsne.funcsne_step(cfg_kf, s_r, X, hp, ops=recr.ops)
        count = kernels.LAUNCHES[f"{op}_hd"]
        call = recr.calls[f"{op}_hd"]
        err = held(f"{op} K=128 C={c_k}", *call, False)
        name = f"{op}_hd_K128_C{c_k}"
        (b2_entry if op == "knn_merge_cand" else b4_entry)(
            name, call, err, count, "[j]")
        del recq, recr, s_q, s_r, call
    log(f"[j] C1 B2 and B4 at K = 128, C = {c_k}, one step of each path: "
        f"ids, distances and flags exact against the plain versions on "
        f"quantised X, distances within {TOL_SQDIST_REL} on the real X "
        f"(bound: K <= {MAX_K}, C <= {MAX_C})")

    # C3: the unfused paths repeat bit for bit, one step and 100 steps
    for flags in (dict(scatter_fused=False), dict(gather_fused=False)):
        cfg_f = dataclasses.replace(cfg, **flags)
        runs = [funcsne.funcsne_step(cfg_f, forced(st), X, hp_f)
                for _ in range(2)]
        chunk_f = funcsne.make_chunked_step(
            cfg_f, CHUNK, schedule=funcsne.default_schedule,
            n_iter=ITERS + F_ITERS)
        for _ in range(2):
            s_f = st
            for _ in range(F_ITERS // CHUNK):
                s_f, _, _ = chunk_f(s_f, X, hp)
            runs.append(s_f)
        for name in funcsne.FuncSNEState._fields:
            check(torch.equal(getattr(runs[0], name), getattr(runs[1], name))
                  and torch.equal(getattr(runs[2], name),
                                  getattr(runs[3], name)),
                  f"{flags}: two runs differ in {name}")
        log(f"[j] C3 {next(iter(flags))}=False: two runs of one step and two "
            f"of {F_ITERS} steps from one state are bit-identical (every "
            f"state field)")
        del runs, s_f

    # C2: fit returns (state, snapshots); it is the main path's run
    st_fit, snaps = funcsne.fit(X, cfg=cfg, n_iter=ITERS, hparams=hp,
                                snapshot_every=100, device=dev)
    check(len(snaps) == ITERS // 100 and all(
        sn.shape == (N, cfg.dim_ld) for sn in snaps), f"{len(snaps)} snapshots")
    check(torch.equal(torch.from_numpy(snaps[-1]), st_fit.Y.cpu()),
          "the last snapshot is not the returned Y")
    check(all(torch.equal(getattr(st_fit, f), getattr(st, f))
              for f in funcsne.FuncSNEState._fields),
          "fit differs from the main path's chunks")
    log(f"[j] C2 fit(n_iter={ITERS}, snapshot_every=100): {len(snaps)} "
        f"snapshots of {snaps[0].shape}, the last equal to the returned Y; "
        f"the state equals phase (d)'s bit for bit")
    del st_fit, snaps

    log(f"    total {time.perf_counter() - t_start:.1f}s")

    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
