#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Drives the port's main path (``repro_torch``: ``init_state`` and the chunk
runner with ``default_schedule``, the single-device route of
``python -m repro_torch.launch.embed``) at MNIST's shape, n = 70,000 and
dim_hd = 784, on an MNIST-shaped synthetic dataset, then the paths of the
later slices (flag paths, NND, the MusicGen-large latents pipeline, the
resilient ``fit``, the distributed step on grids of ranks), and checks
them:

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
      version's time; for B1-B3 also their time from CUDA graphs and a
      profiler split of 20 calls by kernel name; and a short profiler
      window of the step;
  (f) the flag paths (gather_fused=False, scatter_fused=False,
      merge_fused=False, c_hd_rev=4, cand_fused=False), each from the main
      path's final state: its kernels against their plain versions at its
      shapes, one step through the kernels against one through the plain
      versions, then F_ITERS steps with the launch counters set to 0 just
      before (its own kernels launched, no other; Y finite; recall above
      RECALL_MIN and above the recall of the state it started from; steps/s
      beside the default path's from the same state); B6 also at
      init_state's C = 32 and at C = 14 of c_hd_rev = 4; the times of B5-B7
      and of B4 at FUnc-SNE's HD and LD-rescore shapes (each also from
      CUDA graphs and split by kernel name); 20-step profiler windows of
      merge_fused=False, scatter_fused=False and gather_fused=False (device
      busy a step, the share of B1, B5 and B7); the segment sum of
      the unfused paths bit-identical over two calls, each of its passes
      (count, scan, place, order and sum) timed from a profiler trace and
      the whole call from CUDA graphs beside ``index_add_``, its run
      lengths (longest, 99th percentile), and the same held on ids with a
      row past the kernel's shared-memory capacity at d = 2 and 8; and the
      cost of the threefry draws of one
      cand_fused=False step;
  (g) nearest-neighbour descent (``repro_torch.core.nnd``, ``NNDConfig()``)
      on the same X: B4 at C = 16 against its plain version, one iteration
      through the kernels against one through the plain versions, then
      ``nnd(max_iter=NND_ITERS, tol=1e-3)`` with the launch counters set to
      0 just before (B1 once, B4 once per iteration, nothing else; the
      update fraction falls; recall above RECALL_MIN), iterations/s, the
      recall after NND_SHORT iterations, and the time of B4 at NND's shape
      (also from CUDA graphs and split by kernel name).

  (h) B8, causal GQA flash attention, alone, through ``flash_attention``:
      MusicGen-large's prefill shape (B 4, S 1500, 32 heads of 64, bf16),
      Qwen2-7B's (B 1, S 4096, 28 query and 4 KV heads of 128, bf16),
      Gemma2-2b's (B 1, S 8192, 8 query and 4 KV heads of 256, softcap 50)
      with window 4096 and 0, and MusicGen's shape in float32.  bf16 at D
      64, 80, 128 and 256 takes the tensor-core kernel (wgmma, TMA), float32 at
      D 64 and 128 its float32 counterpart (3xTF32 on wgmma), every other
      dtype and D the SIMT kernel (each case checks which one launched);
      each kernel against the plain version (TOL_ATTN_F32, one bf16 ulp),
      and each case times its tensor-core kernel and the SIMT kernel in
      turns (plain, tensor-core, SIMT, tensor-core) beside the bound and,
      without softcap or window, ``F.scaled_dot_product_attention`` as the
      yardstick.  Checked too, through the routed calls: a ragged S (1,499)
      and the model's (B, S, H, D) layout through strides, at each D of
      both tensor-core kernels (at D 80 also an S of 24, which fills no
      tile), and float32 at D 96 (the SIMT kernel);
  (i) the latents pipeline of ``repro_torch.examples.embed_latents`` with
      MusicGen-large at full width and depth (48 layers, d_model 2048,
      float32 params from ``init_params(0)`` by threefry on the card, bf16
      compute): one batch of 64 through B8 against one through the plain
      ``flash_chunked`` (TOL_LATENTS), both B8 kernels at that path's
      shape, then with the launch counters set to 0 the forward over N_SEQ
      sequences of 24 frames (B8's tensor-core kernel 48 times a batch,
      its SIMT kernel never, nothing else; tokens/s), one batch of it in
      float32 compute with the counters at 0 (the float32 tensor-core
      kernel 48 times, nothing else), one batch of the config's smoke
      variant (float32, heads of 32: the SIMT kernel once a layer, nothing
      else; then again with each call held against the plain version,
      the hidden states against the plain ``flash_chunked``'s, and the
      SIMT kernel timed at that shape), PCA 16; the
      fit's B1, B2 and B3 at its shapes (dim_hd 16, dim_ld 8) from
      init_state and one step against their plain versions, and one step
      kernels vs plain; then with the counters at 0 ``fit`` with dim_ld 8
      over 500 steps (steps/s) and one-shot 1-NN on the latents, pca16 and
      funcsne8 (funcsne8 >= ACC_MIN);
  (j) the repairs: C1, embedding widths C1_WIDTHS on the same X (B1-B3, B5
      and B7 against their plain versions, the segment sum bit for bit
      against the CPU's ``index_add_``, one step kernels vs plain, a
      50-step chunk on the kernels equal to its steps one by one, and
      where those steps part from the plain versions' (reported)), B5 and
      B7 on the warp route at a compile-time width no C1 row runs (one step
      of each of their paths at dim_ld 16), a sweep of B5's and B7's
      routes against their warp route (widths 1-4, 8 and 32, B = 1 and an
      odd 3,001, one to four segments, two rows a warp at K 7 and 16, two
      chunks at K 48, misaligned rows), and B2 and B4 at
      K = 128, C = 64 from one step of such a config; B3, B2's LD
      refinement and B2/B4 at K = 128 also from CUDA graphs and split by
      kernel name (B5 and B7 from CUDA graphs in
      ``scripts/forces_merge_ab.py``); each row's
      launches counted over a step or chunk of its own path and shape; C3,
      two runs of one step and of F_ITERS
      steps of ``scatter_fused=False`` and ``gather_fused=False`` from one
      state bit-identical; C2, ``fit(snapshot_every=100)`` returns 5
      snapshots, the last the returned Y, and a state equal to (d)'s;
  (k) the secondary algorithms and the session controls, with the phase's
      wall time: ns-70k, ``negative_sampling_embed`` on X (k_hd 32, 8
      negatives, dim_ld 2, NS_ITERS iterations): B7 at both of its shapes
      and the segment sum against their plain versions, one iteration
      kernels vs plain, then the run with the launch counters at 0 (B7
      twice an iteration, the segment sum once, nothing else; Y finite;
      iterations/s and the R_NX AUC on (d)'s subsample), B7's two shapes
      and the segment sum timed; tsne-5k, ``exact_tsne`` on (d)'s 5,000-row
      subsample (its analytic gradient against torch.autograd's of
      ``kl_loss`` within TOL_GRAD_REL, TSNE_ITERS iterations, Y finite, KL
      below its start, AUC); hierarchy-70k, ``extract_hierarchy`` on X at
      dim_ld 4 with the alphas and depths of examples/hierarchy_graph.py
      (B1-B3 only; clusters, edges and DBSCAN's time a level; DBSCAN on the
      card bit for bit the CPU's on a quantised 5,000-row subsample of the
      last snapshot); session-70k, every third row active, three waves of
      ``fit(state=..., n_iter=SESSION_ITERS)`` with ``add_points`` of the
      next residue class mod 3 between them, then ``remove_points`` of
      class 0 and SESSION_REMOVE_ITERS steps (the audit all zero on every
      state, exact counts on a copy with planted faults, recall@32 of the
      active rows against ``exact_knn(active=)``, the removed rows' Y
      unchanged, one step from wave 0's state kernels vs plain).
  (l) resilience-70k: ``fit`` at the main path's config (ITERS steps in
      chunks of CHUNK) under a ``ResiliencePolicy`` in a temporary
      checkpoint directory, each run with its own: a clean run
      (checkpoint_every=2, audit_every=5, sticky_fallback off) bit for bit
      phase (d)'s state, no rollback, no demotion, the main path's kernels
      launched, steps/s beside a plain ``fit`` of this call and a policy
      run without checkpoints (also phase (d)'s state); a NaN chunk
      (``NaNChunk`` at chunk L_NAN_CHUNK): one rollback, Y finite, the
      backoff logged; a preemption at chunk L_PREEMPT_CHUNK, then
      ``fit(resume_from=)`` bit for bit phase (d)'s state; the newest
      boundary damaged (``CorruptShard``): ``python -m
      repro_torch.checkpoint.verify`` reports it CORRUPT and exits 1, the
      resume falls back one boundary with a ``checkpoint_fallback`` event
      and still ends bit for bit on phase (d)'s state; a
      ``KernelLaunchFault("knn_merge", at_launch=L_FAULT_LAUNCH)`` under
      sticky_fallback: the fault surfaces from ``fit`` with one
      ``kernel_fault`` event, nothing is demoted and no plain version runs
      on the card (B2 launched exactly L_FAULT_LAUNCH times), and
      ``fit(resume_from=)`` of its last boundary launches every kernel of
      the main path and ends bit for bit on phase (d)'s state; the
      save's host ms, the bytes of a checkpoint, wait(), restore and verify
      ms; and ``repro_torch.examples.dynamic_stream`` on X with
      session-70k's waves (recall of the active rows a wave, events).
  (m) the distributed step (``make_distributed_step`` through
      ``runtime.coordinator.fit_elastic``) on the one card: (m2), run in
      phase (e) where the profiler splits a call by kernel, holds the
      kernels at the slices of these grids against their plain versions as
      in phase (b) and times them (recorded from phase (d)'s state through
      a ``RankView``): B1 on X, B2's LD rescore and B3 on rows
      35,000-69,999 (rank 1 of (2, 1)), B1 on every row of X[:, 392:]
      (rank 1 of (1, 2)), and B1 on rows 35,000-69,999 of X[:, :392]
      (rank 2 of (2, 2), held only); each row's launches are those of the
      (m3) run of its shape; (m1) collectives on the card,
      one rank under NCCL (the backend's own calls) and two ranks on
      cuda:0 under gloo (through ``launch.mesh.Grid``: an int32 all-gather,
      a bf16 sum, min and max, each exact on CUDA tensors), each backend
      printed; (m3) mnist-70k over grids, (2, 1)
      twice and (1, 2) as the two gloo ranks and (1, 1) under NCCL, each
      M_ITERS steps in chunks of CHUNK with the default schedule and the
      launch counters at 0 just before: B1, B2 LD and B3 launched on every
      rank and B2's HD merge never, Y finite, a hash of every state field
      equal across ranks and across the two (2, 1) runs, recall@32 on
      (d)'s subsample above RECALL_MIN beside (d)'s and the AUC beside
      (d)'s, steps/s, and each collective's bytes and ms a step; (m4) a
      ``NaNChunk`` in rank 1's replica of ``vel`` at step M_FAULT_AT of a
      (2, 1) run: the reduced probe trips on both ranks, one rollback, Y
      finite.  Two ranks time-share one card, so no step rate here is a
      multi-GPU speed.
  (n) the elastic runtime across hosts: (n1) mnist-70k on two gloo ranks
      on cuda:0 as two simulated hosts (``fit_elastic(n_hosts=2)``, a
      checkpoint every chunk), host 1 lost at step N_LOSS_AT: the events
      ``host_lost`` -> ``remesh`` to a (1, 1) grid, step ITERS reached with Y
      finite, recall@32 above RECALL_MIN beside (d)'s and (m)'s (2, 1),
      the port's fsck passing every committed boundary (two shard files a
      boundary before the loss), and the run ending bit for bit where a
      one-rank ``fit_elastic`` resumed from a copy of the restored boundary
      ends; the quiesce, remesh, restore and verify host ms, the bytes a
      shard, the steps redone and steps/s before and after the loss.  (n2)
      ``runtime.control.Supervisor`` with two worker processes on cuda:0
      (gloo) on the reference supervisor's blobs at 70,000 x 784, pod 1
      SIGKILLing itself at step N_KILL_AT, and the same without a kill:
      every assertion of ``scenario_process_kill``, the relaunched worker's
      launches of B1, B2 LD and B3, the spread ratio of the two runs inside
      SPREAD_RANGE, recall@32 and AUC of both (restored from their last
      boundaries), and what the kill cost on the trail's clock (to
      ``heartbeat_lost``, ``generation_killed``, the new ``worker_start``,
      its ``restore``, its first boundary past it), the steps redone and
      the two runs' wall times.  Each run's launches are counted from
      zero in its own processes, gated (every kernel of a grid's run
      launched) and printed on the [n1] / [n2] lines; they add to no row
      of the ``kernels`` line, whose rows each keep the count of their own
      path's run.
  (o) the LM serving path and A7's examples, in a process of its own
      (``chip_smoke.py --serve-phase PATH``; in this one the profiler
      records no kernel after phase (l)): (o1) Gemma2-2b at full width and
      O_GEMMA_LAYERS of its 26 layers and (o2) OLMoE-1B-7B at full width
      and depth (float32 params by threefry on the card, bf16 compute;
      OLMoE at capacity factor 8, nothing drops),
      each with ``hidden_states`` of seeded tokens through B8 with the
      launch counters at 0 just before (the tensor-core kernel once a
      layer, nothing else) and through the plain ``flash_chunked_ref``
      (TOL_LATENTS), a second, warm ``hidden_states`` under the profiler
      (device busy share, B8's device ms in it), B8 held and timed at each
      attention shape of the path (a row each: Gemma2's local window-4,096
      and global layers, OLMoE's),
      teacher-forced ``serve_step`` from ``init_cache`` held against the
      prefill's logits (TOL_DECODE; Gemma2 every one of its 4,352
      positions, held at the first O_FIRST and the last O_LAST, past the
      window, with top-1 agreement at least TOP1_MIN and two planted
      faults, a cache slot and the window mask, each read above
      TOL_DECODE; OLMoE 256), no kernel launched by decode, decode tokens/s and
      ms a step, the device's busy share of O_PROFILE decode steps, the
      cache bytes and the peak memory; OLMoE's ``dropped_frac`` at the
      default capacity factor 1.25, and ``moe_apply`` and its combine run
      twice bit-identical (``index_add_``'s sum printed beside); (o3) A7's
      examples at the reference's sizes (``quickstart``,
      ``interactive_hparams`` with its kernel library builds after the first
      phase, which must be 0, and its alpha-0.5 phase's clusters more than
      twice any other phase's, and ``hierarchy_graph``; B3 once a step),
      beside the numbers the JAX examples print on the CPU.
  (p) serving for the last three LM families, in a process of its own as
      phase (o) (``chip_smoke.py --serve-phase-p PATH``): (p1)
      DeepSeek-V2 at full width and 4 of its 60 layers (MLA, 160 routed
      experts top-6 and 2 shared, bf16 params, capacity factor 8), (p2)
      Mamba2-130m and (p3) Zamba2-2.7b at full width and depth, each
      through ``serve_model`` as in phase (o): ``hidden_states`` with the
      launch counters at 0 just before (B8 once a layer on the tensor-core
      kernel at D 192, Dv 128 for DeepSeek; none for Mamba2; once a
      super-block on the tensor-core kernel at D 80 for Zamba2), B8 held
      and timed on the path (the SIMT kernel timed beside, DeepSeek's and
      Zamba2's), decode of
      every position held against the prefill (TOL_DECODE; Mamba2 and
      Zamba2 TOL_DECODE_SSM, and Zamba2's hidden states through B8
      against the plain version TOL_LATENTS_SSM) with one planted fault
      each read above it (the MLA latent pair a slot late; the SSM state
      not decayed), decode ms a step and tokens/s, the busy share, cache
      bytes and peak memory; Mamba2's chunk scan against its recurrence on
      layer 0's inputs (TOL_SSD), and its decode against its prefill in
      float32 compute (TOL_DECODE_F32).
  (q) LM training, in a process of its own as phase (o)
      (``chip_smoke.py --train-phase-q PATH``): (q1) B8's backward kernel
      (``csrc/flash_attention_bwd.cu``, ``launch_bwd``) at each shape of
      BWD_CASES, in the model's (B, S, H, D) layout through strides,
      against ``flash_attention_bwd_ref`` (TOL_ATTN_BWD_F32, one bf16 ulp),
      a second launch bit-identical, its time beside the bound, the plain
      backward's and, without softcap or window, SDPA's backward; (q2)
      every parameter's gradient of train_lm's first loss through B8 and
      its backward kernel against the plain attention's under autograd
      (TOL_TRAIN_GRAD), two planted faults read above it (B8-bwd's dK and
      dV swapped; attention's gradient cut), then
      ``repro_torch.examples.train_lm`` on the card (reduced qwen2-7b, 300
      steps at B 8 x 256, a checkpoint every 50) with the launch counters
      at 0 just before: B8's forward (the SIMT kernel at D 32) and its
      backward once a layer a step, nothing else; the mean loss of the
      last Q_WINDOW steps below the first's; then ``--fail-at Q_FAIL_AT``
      into a fresh directory and the rerun, which restores the last
      boundary and gives the uninterrupted run's losses bit for bit;
      tokens/s, ms a step; (q3) MusicGen-large at full width and depth
      (3.2 B float32 params, bf16 compute, remat "nothing", AdamW
      float32 moments): Q3_STEPS steps on one batch with the counters at 0
      just before (B8's tensor-core kernel twice a layer a step, its
      backward once), every loss finite, the last below the first, the
      first within TOL_TRAIN_LOSS of the plain attention's, with the plain
      loss with attention's output zeroed read above it; the peak memory,
      ms a step, tokens/s.

B1 runs the lane route on rows of at most 8 floats (the LD lists at dim_ld
2, 5, 8), the ring route on rows of 128 to 1,024 floats with M % 4 == 0
(MNIST's 784), the warp route elsewhere (16, dim_ld 32, 783 columns, a
misaligned x); phase (b) holds each route against the plain version (lanes
at d = 2 with C 16 and 24, ring at 784 with C 32 and 10, warp at 783 and
16), and phases (e), (f), (g), (i) and (j) time it at every shape a path
gives it (init_state's HD and LD lists, merge_fused=False's HD and LD
calls, NND's start, the latents fit's start, merge_fused=False's LD call at
dim_ld 5, 8, 32, and 783 columns and a misaligned X on the warp route),
each row with its rows scored, GB gathered and rate from CUDA graphs; phase
(f) also profiles 20 steps of merge_fused=False (device busy a step, B1's
share). B2 and B4 run the lane route where rows have at most 8 floats and
K + C <= 32 (the LD refinement at dim_ld 2, 5, 8), the ring route on rows
of 128 to 1,024 floats with M % 4 == 0 (HD and NND at MNIST's 784, K = 128),
the warp route elsewhere (the latents' 16-wide HD, dim_ld 32, 783 columns);
each route has its own launch counter, and every expected-launch set
follows the route of its shape. Phase (g) also runs NND a second time under
the profiler (device busy an iteration; B4's mean launch and share over the
run) and holds and times B4 on that run's last iteration. B4's warp route
is held in phase (f), on the cand_fused=False HD call at 783 of X's columns
(quantised and real), and in phase (i), where a CHUNK-step chunk of
cand_fused=False on the 16-wide latents drives it with the counters at 0
(held on the grid and on the real latents, and timed).

B5 and B7 run the rounds route on rows of at most 4 floats (the flag
paths at dim_ld 2), the staged route at 8 and 32 floats (dim_ld 8, 32),
the warp route elsewhere (dim_ld 5, 16); each route has its own launch
counter
(``edges_key``) and every expected-launch set follows the route of its
width.  Every B5 and B7 call held in phases (f) and (j) also checks that it
launched its own route once and nothing else, that its outputs are bit
for bit the warp route's (int32 views), and on quantised inputs that its
edges equal the plain version's exactly.

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

import contextlib
import dataclasses
import json
import math
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
TF32_FLOPS_PER_S = 494.7e12    # H100 SXM, TF32 tensor cores, dense
# tolerances of the float comparisons, kernel vs plain version on the card
# the segment sum's passes, by the kernels that run them
SEG_PASSES = {"count": ("count_kernel",),
              "scan": ("column_scan_kernel", "group_scan_kernel"),
              "place": ("place_kernel",),
              "order_and_sum": ("group_sum_kernel",)}
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
# MusicGen-large's prefill of 30 s of 50 Hz frames, Qwen2-7B's at 4k,
# Gemma2-2b's local and global layers at 8k (bf16: the tensor-core kernel,
# timed beside the SIMT kernel), and MusicGen's in float32 (the float32
# tensor-core kernel, timed beside the SIMT kernel)
ATTN_CASES = (
    ("flash_attention_musicgen", 4, 32, 32, 1500, 64, torch.bfloat16, 0.0, 0,
     20),
    ("flash_attention_qwen2", 1, 28, 4, 4096, 128, torch.bfloat16, 0.0, 0,
     10),
    ("flash_attention_gemma2_w4096", 1, 8, 4, 8192, 256, torch.bfloat16, 50.0,
     4096, 5),
    ("flash_attention_gemma2_w0", 1, 8, 4, 8192, 256, torch.bfloat16, 50.0, 0,
     5),
    ("flash_attention_fp32", 4, 32, 32, 1500, 64, torch.float32, 0.0, 0, 20),
)
# (name, B, Hq, Hkv, S, D, Dv, dtype, softcap, window, layout) of phase
# (h), checked only, through the routed call: S that fills no tile, and the
# model's (B, S, H, D) layout through strides, at each width of the two
# tensor-core kernels, DeepSeek-V2's MLA pair (D 192, Dv 128) among them;
# one float32 case at D 96 and MLA's pair in float32, which route to the
# SIMT kernel.  At D = 256 (bf16) and D = 64 (float32) a CTA holds 128
# query rows, and S = 1,050 leaves the last CTA's second warpgroup no row.
# At D 80 (Zamba2-2.7B's shared block: the Q and K tiles' second box of 64
# columns overhangs the row, V's last 16 columns take a box of their own)
# also an S of 24, which fills no tile
ATTN_CHECKS = (
    ("ragged_d64", 2, 8, 4, 1499, 64, 64, torch.bfloat16, 0.0, 0, "bhsd"),
    ("ragged_d128_window", 1, 8, 2, 1499, 128, 128, torch.bfloat16, 0.0, 700,
     "bhsd"),
    ("strided_d128", 2, 16, 4, 1500, 128, 128, torch.bfloat16, 0.0, 0,
     "bshd"),
    ("strided_d256_softcap_window", 1, 8, 4, 1050, 256, 256, torch.bfloat16,
     50.0, 300, "bshd"),
    ("mla_strided_ragged_d192_v128", 2, 16, 16, 1499, 192, 128,
     torch.bfloat16, 0.0, 0, "bshd"),
    ("mla_strided_d192_v128_window", 1, 8, 8, 1050, 192, 128, torch.bfloat16,
     0.0, 300, "bshd"),
    ("ragged_d80", 2, 8, 4, 1499, 80, 80, torch.bfloat16, 0.0, 0, "bhsd"),
    ("zamba2_strided_d80_softcap_window", 1, 32, 32, 1050, 80, 80,
     torch.bfloat16, 50.0, 300, "bshd"),
    ("short_d80", 2, 8, 4, 24, 80, 80, torch.bfloat16, 0.0, 0, "bhsd"),
    ("f32_ragged_d64", 2, 8, 4, 1499, 64, 64, torch.float32, 0.0, 0, "bhsd"),
    ("f32_strided_d64_softcap_window", 2, 8, 4, 1050, 64, 64, torch.float32,
     50.0, 300, "bshd"),
    ("f32_strided_d128_window", 2, 16, 4, 1500, 128, 128, torch.float32, 0.0,
     700, "bshd"),
    ("f32_simt_d96", 1, 8, 2, 1499, 96, 96, torch.float32, 0.0, 0, "bhsd"),
    ("f32_simt_mla_strided_ragged_d192_v128", 1, 8, 8, 1499, 192, 128,
     torch.float32, 0.0, 0, "bshd"),
)
B8_SOURCE = {"wgmma": "src/repro_torch/csrc/flash_attention_wgmma.cu",
             "tf32": "src/repro_torch/csrc/flash_attention_tf32.cu",
             "simt": "src/repro_torch/csrc/flash_attention.cu"}
B8_LABEL = {"wgmma": "tensor-core", "tf32": "float32 tensor-core (3xTF32)",
            "simt": "SIMT"}
B8_REPLACES = "src/repro/kernels/flash_attention/kernel.py:86"
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
# phase (k): negative-sampling iterations (the JAX default), exact t-SNE
# iterations on the 5,000-row subsample, the alpha sweep of
# examples/hierarchy_graph.py (warmup and steps a level), and the session's
# steps a wave and after the removal
NS_ITERS, TSNE_ITERS = 750, 500
HIER_ALPHAS, HIER_ITERS = (3.0, 1.0, 0.5), 300
SESSION_ITERS, SESSION_REMOVE_ITERS = 300, 100
# phase (l): the chunk a NaN poisons, the chunk boundary a preemption (and a
# damaged checkpoint) hits, and the guarded B2 launch a kernel fault
# replaces (about two fifths into the run)
L_NAN_CHUNK, L_PREEMPT_CHUNK, L_FAULT_LAUNCH = 3, 6, 300
# phase (m): steps of each grid's fit_elastic run -- (2, 1) twice and (1, 2)
# as two gloo ranks on the one card, (1, 1) as one NCCL rank -- the step of
# the NaN chunk confined to rank 1's replica and that run's steps, and each
# spawn's hard time limit in seconds
M_ITERS = {(2, 1): 500, (1, 2): 500, (1, 1): 500}
M_FAULT_AT, M_FAULT_ITERS = 100, 200
M_TIMEOUT = 900
# phase (n): (n1) the step a simulated host is lost at, (n2) the boundary a
# worker SIGKILLs itself at, in ITERS steps in chunks of CHUNK; the spawn's
# and each supervised run's time limits in seconds; the bound of the spread
# ratio of the killed and the unkilled supervised runs (the reference's
# host-loss scenario's)
N_LOSS_AT, N_KILL_AT = 250, 250
N_TIMEOUT = 300
SPREAD_RANGE = (0.5, 2.0)
# phase (o), the LM serving path and A7's examples, in a process of its own
# (in this one the profiler records no kernel after phase (l), and the
# earlier phases' memory is gone there): (arch, batch, prefill tokens, decode
# steps).  Gemma2-2b: the local window 4,096 plus 256, every position
# decoded; OLMoE-1B-7B at capacity factor 8 (the reference's decode test:
# nothing drops), 256 positions decoded; O_LAST / O_FIRST the positions of
# Gemma2's prefill logits that its decode is held to (the last past the
# window, where the local layers' decode mask bites); O_PROFILE decode steps
# under the profiler; the child's time limit in seconds.  Gemma2 runs at
# O_GEMMA_LAYERS of its 26 layers (4 pairs; every width and the 4,352
# positions kept, so the decode past the window is still held), to leave
# phase (p) its time in the script's 1,200 s
O_GEMMA = ("gemma2-2b", 2, 4352, 4352)
O_GEMMA_LAYERS = 8
O_OLMOE = ("olmoe-1b-7b", 4, 1024, 256)
O_LAST, O_FIRST, O_PROFILE = 256, 64, 32
O_TIMEOUT = 600
# phase (p), serving for the last three LM families, in a process of its
# own as phase (o): (arch, layers or None for the registered depth, batch,
# prefill tokens, decode steps).  DeepSeek-V2 at 4 of its 60 layers (the
# dense first layer and 3 MoE layers, 27.2 GB of bf16 params; the 60 layers'
# 480 GB fit no card), capacity factor 8 (nothing drops); Mamba2-130m and
# Zamba2-2.7b at full depth.  The child's time limit in seconds
P_DEEPSEEK = ("deepseek-v2-236b", 4, 2, 1024, 128)
P_MAMBA = ("mamba2-130m", None, 4, 4096, 256)
P_ZAMBA = ("zamba2-2.7b", None, 2, 2048, 128)
P_TIMEOUT = 480
# _ssd_chunk_scan against ssd_reference on the card at Mamba2's shape, max
# |difference| over the largest |y|: the same float32 recurrence, the
# chunk's decays as exp of cumulative sums against a product of per-step
# decays, summed in another order over 4,096 steps (the reference's own
# test holds 1e-4 at S 96)
TOL_SSD = 1e-4
# decode against prefill for Mamba2 and Zamba2 in bf16, a bound of their
# own: both round the same bf16 values at other points (projections over
# one row against over the batch's rows, the chunk's exp of cumulative sums
# against a product of per-step decays), and a stack of random-weight SSD
# mixers amplifies a 1-ulp difference more than an attention stack does:
# Mamba2-130m at full width reads 0.092 on an H100 over 256 positions, and
# ``scripts/ssm_decode_cpu.py`` on the CPU 0.086 over 64 (top-1 0.84), where
# float32 compute reads 2.6e-5 (the algorithm agrees) and the state not
# decayed 1.41.  The planted fault must read above the bound
TOL_DECODE_SSM = 0.25
# Zamba2's hidden states through B8 against those through the plain
# flash_chunked, relative Frobenius: TOL_LATENTS's bf16 rounding, amplified
# through 54 SSD mixers as above (0.0537 on an H100 at 2 x 2,048 tokens)
TOL_LATENTS_SSM = 0.15
# Mamba2's decode against its prefill in float32 compute on the card, its
# first P_F32 positions: the same float32 arithmetic in another order (no
# TF32: serve_main_p turns it off)
TOL_DECODE_F32, P_F32 = 1e-3, 64
# phase (q), LM training, in a process of its own as (o) and (p); the
# child's time limit in seconds
Q_TIMEOUT = 300
# B8's backward against its plain version (flash_attention_bwd_ref) on the
# card: each gradient within TOL_ATTN_BWD_F32 of its largest |entry| (the
# same float32 quantities summed in another order: dK and dV over every row
# that sees a key, dQ over its keys); in bfloat16 also one bf16 ulp of the
# larger of the two values (both round a float32 result to bf16)
TOL_ATTN_BWD_F32 = 1e-4
# (name, B, S, Hq, Hkv, D, Dv, dtype, softcap, window, timing reps) of
# (q1), in the model's (B, S, H, D) layout through strides: train_lm's
# shape (reduced qwen2-7b, float32, the SIMT forward), MusicGen-large's at
# (q3)'s batch, Qwen2-7B's at 4k, Gemma2-2b's local and global layers,
# DeepSeek-V2's MLA prefill, Zamba2-2.7B's shared block, and float32 at D
# 64 and 128 (the 3xTF32 forward)
BWD_CASES = (
    ("flash_attention_bwd_train_lm", 8, 256, 8, 4, 32, 32, torch.float32,
     0.0, 0, 20),
    ("flash_attention_bwd_musicgen", 2, 1024, 32, 32, 64, 64,
     torch.bfloat16, 0.0, 0, 5),
    ("flash_attention_bwd_qwen2", 1, 4096, 28, 4, 128, 128, torch.bfloat16,
     0.0, 0, 2),
    ("flash_attention_bwd_gemma2_w1024", 2, 2048, 8, 4, 256, 256,
     torch.bfloat16, 50.0, 1024, 3),
    ("flash_attention_bwd_gemma2_w0", 2, 2048, 8, 4, 256, 256,
     torch.bfloat16, 50.0, 0, 3),
    ("flash_attention_bwd_deepseek", 2, 1024, 128, 128, 192, 128,
     torch.bfloat16, 0.0, 0, 2),
    ("flash_attention_bwd_zamba2", 2, 2048, 32, 32, 80, 80, torch.bfloat16,
     0.0, 0, 3),
    ("flash_attention_bwd_f32_d64", 2, 1024, 32, 32, 64, 64, torch.float32,
     0.0, 0, 3),
    ("flash_attention_bwd_f32_d128", 1, 2048, 16, 4, 128, 128,
     torch.float32, 0.0, 0, 3),
)
# (q2): repro_torch.examples.train_lm on the card (reduced qwen2-7b, 300
# steps at B 8 x 256, a checkpoint every 50), then --fail-at Q_FAIL_AT into
# a fresh directory and the rerun, which resumes at Q_RESUME_AT; the mean
# loss of the first and of the last Q_WINDOW steps
Q_FAIL_AT, Q_RESUME_AT, Q_WINDOW = 130, 100, 20
# (q2): every parameter's gradient of train_lm's first loss (its init, its
# first batch) through B8 and B8-bwd against the plain attention's
# (flash_chunked_ref under autograd): each leaf's max abs difference over
# its largest |entry|.  Both are float32 throughout (no TF32) and sum in
# another order; each run plants two faults and holds each reading above
# the bound: B8-bwd's dK and dV swapped (D = Dv here), and attention's
# gradient cut (the fault C5 was).  On an H100 (700 W) the sound run reads
# 2.4e-6, the swap 15.2 and the cut 1.0
TOL_TRAIN_GRAD = 1e-3
# (q3): MusicGen-large at full width and depth, Q3_STEPS AdamW steps on one
# batch of B 2 x S 1,024 (no warm-up: warmup_cosine(Q3_LR, 0, Q3_STEPS));
# the first loss against the same step's loss with the plain attention
# (flash_chunked_ref, forward only), relative: both run bf16 compute over
# 48 layers and round at other points (TOL_LATENTS reads 5e-2 on the
# hidden states), while the mean NLL over 2,048 tokens averages those
# differences out.  At random weights the loss barely sees attention: the
# plain loss with attention's output zeroed in every layer, planted on
# every run and held above the bound, reads 2.42e-3 and the sound run
# 5.585e-5 (an H100, 700 W), and the bound sits between them
Q3_SHAPE, Q3_STEPS, Q3_LR = (2, 1024), 4, 1e-5
TOL_TRAIN_LOSS = 4e-4
B8_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
B8_BWD_REPLACES = ("none (new: the backward of "
                   "src/repro/kernels/flash_attention/kernel.py:86, which is "
                   "forward only)")
# decode against prefill: max |logit difference| over the largest |logit|.
# Both run bf16 compute but round at other points (decode attention sums in
# float32 over the bf16 cache; B8 rounds its output to bf16), and bf16
# rounds each layer's residual stream at 2^-8 relative.  Each run plants two
# faults in Gemma2's decode (``_planted_faults``) and holds each reading
# above the bound: the cache read one slot off (the first O_FIRST
# positions) and the local layers' window mask off (the last O_LAST,
# resumed from the sound run's cache before the window bites).  On an H100
# (700 W), with Gemma2 at O_GEMMA_LAYERS layers, the sound decode reads
# 0.0215 (Gemma2's first 64 positions), 0.0222 (past the window), 0.0222
# (OLMoE) and 0.0180 (DeepSeek-V2, phase (p1)), the window fault 0.0822 and
# the slot fault 0.410: the bound sits 2.0x above the largest sound reading
# and 1.8x below the window fault (at Gemma2's 26 layers the readings were
# 0.048 and 0.120, under a bound of 0.075; ``scripts/decode_faults_cpu.py``
# gives the same order at a small width on the CPU)
TOL_DECODE = 0.045
# Gemma2's decode against its prefill: the share of positions whose top
# logit agrees
TOP1_MIN = 0.99
# the numbers the JAX package's examples print (examples/*.py, run once on
# the CPU with JAX_PLATFORMS=cpu; PERF.md): quickstart's three qualities,
# interactive_hparams' cluster count a phase, hierarchy_graph's counts a
# level and its strong edges
JAX_QUICKSTART = {"hd_knn": 0.998, "embedding": 0.265, "one_nn": 1.000}
JAX_INTERACTIVE = (11, 4, 26, 4, 10)
# the counts themselves are chaotic (each package's runs from Y nudged by
# 1e-7 of itself spread over 1-11 clusters a phase: PERF.md): what is held
# is the effect the example shows, alpha 0.5 (the third phase) giving more
# than twice the clusters of any other phase
JAX_HIERARCHY = ([1, 1, 16], 17)
# exact_tsne_grad against torch.autograd's gradient of kl_loss, of max|g|:
# the same float32 quantities summed in another order over 5,000 columns
TOL_GRAD_REL = 1e-5
# B5 and B7: their entry points, and the kernel each route launches (by the
# name the profiler gives it)
EDGE_OPS = ("ne_forces", "ne_forces_gather")
EDGE_KERNELS = {"rounds": "forces_rounds_kernel",
                "staged": "forces_staged_kernel",
                "warp": "forces_edges_kernel"}


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


def graph_ms(fn, reps):
    """Mean ms per call of ``fn`` replayed from a CUDA graph of ``reps``
    calls: the device's time without the host's cost of each launch, for a
    call too short to hide it."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    g.replay()
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


def attn_close(got, want, name, rtol=TOL_ATTN_F32):
    """Check B8's output (or a gradient of its backward) against its plain
    version: within ``rtol`` (TOL_ATTN_F32, or TOL_ATTN_BWD_F32) of the
    largest |entry|, plus one bf16 ulp in bfloat16; returns the max abs
    error."""
    g, w = got.float(), want.float()
    tol = rtol * float(w.abs().max())
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


class RankView:
    """One rank's view of a ``(data, model)`` grid, in this process: its
    axis sizes and indices, and collectives that only keep shapes (a
    gather tiles its input, a reduction returns it).  Phase (m) runs a
    step's phases on it through recording ops, to get the kernel calls
    that rank makes at its row slice."""

    def __init__(self, shape, coords):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(zip(self.axis_names, coords))

    def _axes(self, axes):
        return (axes,) if isinstance(axes, str) else tuple(axes or ())

    def axis_size(self, axes):
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes):
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def all_gather(self, x, axes, tag=None):
        return torch.cat([x] * self.axis_size(axes))

    def all_reduce(self, x, axes, op="sum", tag=None):
        return x


def collectives_check(rank, world, dev):
    """Phase (m1) on one rank: a tiled all-gather of int32 and a bf16 sum,
    min and max over the rank's process group, each against the value it
    must give exactly.  One rank (NCCL): the backend's own calls.  Two or
    more: through ``launch.mesh.Grid``.  Returns (backend, what failed)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    backend = dist.get_backend()
    failed = []
    ids = torch.arange(5, dtype=torch.int32, device=dev)
    want_ids = torch.cat([ids + 100 * r for r in range(world)])
    vals = [((torch.arange(64, device=dev) * 0.37 + r) ** 2).to(
        torch.bfloat16) for r in range(world)]
    acc = vals[0].float()
    for v in vals[1:]:
        acc = acc + v.float()
    want_sum = acc.to(torch.bfloat16)
    mine = ids + 100 * rank
    if world == 1:
        parts = [torch.empty_like(mine)]
        dist.all_gather(parts, mine)
        got_ids = torch.cat(parts)
        got_sum = vals[0].clone()
        dist.all_reduce(got_sum)
        got_min = torch.tensor(float(rank), device=dev)
        dist.all_reduce(got_min, op=dist.ReduceOp.MIN)
        got_max = got_min.clone()
        dist.all_reduce(got_max, op=dist.ReduceOp.MAX)
    else:
        grid = mesh_lib.Grid((world, 1))
        got_ids = grid.all_gather(mine, "data")
        got_sum = grid.all_reduce(vals[rank], "data", "sum")
        r_ = torch.tensor(float(rank), device=dev)
        got_min = grid.all_reduce(r_, "data", "min")
        got_max = grid.all_reduce(r_, "data", "max")
    for name, ok in (("all_gather int32", torch.equal(got_ids, want_ids)),
                     ("bf16 sum", torch.equal(got_sum, want_sum)),
                     ("min", float(got_min) == 0.0),
                     ("max", float(got_max) == world - 1.0)):
        if not ok:
            failed.append(name)
    return backend, failed


def mesh_rank(rank, world, dev, jobs, n, dim, rows, sub, chunk):
    """What every rank of phase (m) runs: ``jobs`` in order, each
    ``{"kind": "collectives"}`` (m1) or a ``fit_elastic`` run at MNIST's
    shape (``{"kind": "fit", "model", "iters", "timed", "fault"}``: the
    launch counters and the collective counters set to 0 just before;
    ``fault`` a step for a ``NaNChunk`` in the last rank's replica, under a
    ``ResiliencePolicy``).  A run returns its launches, a hash of every
    state field, the steps/s of its loop (card synchronised at the first
    and the last chunk boundary), the collectives' calls, bytes and ms,
    its policy's events, and on rank 0 the HD lists of ``rows`` and the Y
    of ``sub``."""
    import contextlib as ctxlib
    import hashlib

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import funcsne
    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import faults
    from repro_torch.runtime.coordinator import fit_elastic

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out, X = [], None
    for job in jobs:
        if job["kind"] == "collectives":
            out.append(collectives_check(rank, world, dev))
            continue
        if X is None:
            X = torch.from_numpy(synthetic.mnist_like(n=n, dim=dim,
                                                      seed=0)[0]).to(dev)
        cfg = funcsne.FuncSNEConfig(n_points=X.shape[0], dim_hd=X.shape[1])
        hp = funcsne.default_hparams(X.shape[0], device=dev)
        policy = script = None
        if job.get("fault") is not None:
            policy = ResiliencePolicy(max_retries=2)
            script = faults.FaultScript(faults.NaNChunk(
                at_step=job["fault"], shard=world - 1, field="vel", rows=4))
        stamps = []

        def beat(it):
            sync()
            stamps.append(time.perf_counter())
        mesh_lib.reset_collectives()
        mesh_lib.set_timed(job["timed"])
        kernels.reset_launches()
        try:
            with faults.active(script) if script else ctxlib.nullcontext():
                st = fit_elastic(X, cfg=cfg, n_iter=job["iters"],
                                 chunk_size=chunk, hparams=hp,
                                 model=job["model"], resilience=policy,
                                 on_boundary=beat, device=dev)
            sync()
        finally:
            mesh_lib.set_timed(False)
        res = {"launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
               "hashes": {f: hashlib.sha256(
                   getattr(st, f).cpu().numpy().tobytes()).hexdigest()
                   for f in funcsne.FuncSNEState._fields},
               "sps": job["iters"] / (stamps[-1] - stamps[0]),
               "collectives": {k: list(v) for k, v in
                               mesh_lib.COLLECTIVES.items()},
               "events": [] if policy is None else policy.events,
               "backend": dist.get_backend(), "step": int(st.step),
               "finite": bool(torch.isfinite(st.Y).all())}
        if rank == 0:
            res["hd_rows"] = st.hd_idx[torch.from_numpy(rows).to(dev)].cpu()
            res["y_sub"] = st.Y[torch.from_numpy(sub).to(dev)].cpu()
        # the rank's CUDA tensors go before its process group does
        out.append(res)
        del st
    return out


def host_loss_rank(rank, world, dev, n, dim, rows, sub, chunk, root):
    """What each rank of phase (n1) runs: ``fit_elastic(n_hosts=2)`` at
    MNIST's shape under a checkpoint every chunk with host 1 lost at step
    N_LOSS_AT (rank 0 copies the checkpoint directory when the remesh is
    logged), then a one-rank ``fit_elastic`` resumed from that copy.
    Returns the events, the launches, a hash of every state field of both
    runs, the host ms of the quiesce, the remesh, the restore and its
    verify, the clock at each boundary, and on rank 0 the HD lists of
    ``rows`` and the Y of ``sub``."""
    import hashlib
    import shutil

    from repro_torch import kernels
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import funcsne
    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.data import synthetic
    from repro_torch.runtime import elastic, faults
    from repro_torch.runtime.coordinator import fit_elastic

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    X = torch.from_numpy(synthetic.mnist_like(n=n, dim=dim, seed=0)[0]).to(dev)
    cfg = funcsne.FuncSNEConfig(n_points=n, dim_hd=dim)
    hp = funcsne.default_hparams(n, device=dev)
    timing = {"remesh": [], "restore": [], "verify": []}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                timing[name].append((time.perf_counter() - t0) * 1e3)
        return run
    # the handler's pieces, timed where they are called
    elastic.remesh = timed("remesh", elastic.remesh)
    Checkpointer.restore_verified = timed("restore",
                                          Checkpointer.restore_verified)
    Checkpointer.verify_step = timed("verify", Checkpointer.verify_step)
    stamps, marks = [], {}
    run_dir, copy_dir = os.path.join(root, "run"), os.path.join(root, "copy")

    def on_event(e):
        marks[e["kind"]] = time.perf_counter()
        if e["kind"] == "remesh" and rank == 0:
            shutil.copytree(run_dir, copy_dir)

    def beat(it):
        sync()
        stamps.append((it, time.perf_counter()))
    policy = ResiliencePolicy(checkpoint_dir=run_dir, checkpoint_every=1,
                              keep_last=ITERS // chunk, on_event=on_event)
    kernels.reset_launches()
    with faults.active(faults.FaultScript(faults.HostLoss(at_step=N_LOSS_AT,
                                                          host=1))):
        st = fit_elastic(X, cfg=cfg, n_iter=ITERS, chunk_size=chunk,
                         hparams=hp, n_hosts=2, model=1, resilience=policy,
                         on_boundary=beat, device=dev)
    sync()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}

    def hashes(s):
        return {f: hashlib.sha256(getattr(s, f).cpu().numpy().tobytes())
                .hexdigest() for f in funcsne.FuncSNEState._fields}
    res = {"events": policy.events, "launches": launches, "stamps": stamps,
           "marks": marks, "timing": {k: list(v) for k, v in timing.items()}}
    if st is not None:
        res.update(hashes=hashes(st), step=int(st.step),
                   finite=bool(torch.isfinite(st.Y).all()),
                   hd_rows=st.hd_idx[torch.from_numpy(rows).to(dev)].cpu(),
                   y_sub=st.Y[torch.from_numpy(sub).to(dev)].cpu())
    del st
    # the fresh run: one rank resumed from the copy of the restored boundary
    fresh_stamps = []
    fresh = fit_elastic(X, cfg=cfg, n_iter=ITERS, chunk_size=chunk,
                        hparams=hp, devices=1, resilience=ResiliencePolicy(
                            checkpoint_dir=copy_dir, checkpoint_every=1),
                        resume_from=copy_dir, device=dev,
                        on_boundary=lambda it: (sync(), fresh_stamps.append(
                            (it, time.perf_counter()))))
    if fresh is not None:
        res.update(fresh_hashes=hashes(fresh), fresh_stamps=fresh_stamps)
    return res


def elastic_phase(X, rows, sub, true_idx, rec_d, auc_d, q_m, expected, card):
    """Phase (n) (see the module docstring): ``X`` is mnist-70k on the card,
    ``rows`` / ``true_idx`` the recall subsample and its exact neighbours,
    ``sub`` the AUC subsample, ``rec_d`` / ``auc_d`` phase (d)'s quality
    and ``q_m`` phase (m)'s (2, 1); ``expected`` the launch counters of a
    grid's run."""
    import io
    import shutil
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.verify import verify_dir
    from repro_torch.core import funcsne, knn
    from repro_torch.core.quality import embedding_quality
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import control, faults

    dev = X.device
    t_n = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def recall_of(hd_rows, truth):
        return float((hd_rows.to(dev)[:, :, None].long()
                      == truth.long()[:, None, :]).any(-1).float().mean())
    root = tempfile.mkdtemp(prefix="chip-smoke-elastic-")
    try:
        # (n1) simulated host loss on mnist-70k
        t0 = time.perf_counter()
        r0, r1 = mesh_lib.run_ranks(
            host_loss_rank, 2, (N, DIM, rows.cpu().numpy(),
                                sub.cpu().numpy(), CHUNK, root),
            device=dev, backend=mesh_lib.pick_backend(dev, 2),
            timeout=N_TIMEOUT)
        t_n1 = time.perf_counter() - t0
        check([e["kind"] for e in r0["events"]] == ["host_lost", "remesh"],
              f"(n1) rank 0 events {r0['events']}")
        hl, rm = r0["events"]
        check(hl == {"kind": "host_lost", "step": N_LOSS_AT, "host": 1}
              and rm["step"] == N_LOSS_AT and rm["n_devices"] == 1
              and rm["n_hosts"] == 1
              and rm["mesh"] == {"data": 1, "model": 1},
              f"(n1) events {r0['events']}")
        check([e["kind"] for e in r1["events"]] == ["host_lost",
                                                    "rank_idle"]
              and "hashes" not in r1 and "fresh_hashes" not in r1,
              f"(n1) rank 1 events {r1['events']}")
        check(r0["step"] == ITERS and r0["finite"],
              f"(n1) step {r0['step']}, Y finite {r0['finite']}")
        for rank, r_ in enumerate((r0, r1)):
            check(set(r_["launches"]) == expected,
                  f"(n1) rank {rank} launched {r_['launches']}")
        check(r0["hashes"] == r0["fresh_hashes"],
              "(n1) the host-lost run differs from the fresh one-rank "
              "resume of the restored boundary")
        rec_n = recall_of(r0["hd_rows"], true_idx)
        auc_n = float(embedding_quality(X[sub], r0["y_sub"].to(dev)))
        check(rec_n > RECALL_MIN, f"(n1) recall {rec_n}")
        run_dir = os.path.join(root, "run")
        t0 = time.perf_counter()
        fsck = io.StringIO()
        bad = verify_dir(run_dir, out=fsck)
        t_fsck = (time.perf_counter() - t0) * 1e3
        check(bad == 0, f"(n1) fsck: {fsck.getvalue()}")
        steps = Checkpointer(run_dir).all_steps()
        check(steps == list(range(CHUNK, ITERS + 1, CHUNK)),
              f"(n1) committed {steps}")
        for s_ in steps:
            d_ = os.path.join(run_dir, f"step_{s_:010d}")
            names = sorted(f for f in os.listdir(d_) if f.endswith(".npz"))
            check(names == (["shard000-of-002.npz", "shard001-of-002.npz"]
                            if s_ <= N_LOSS_AT else ["arrays.npz"]),
                  f"(n1) step {s_} holds {names}")
        d_loss = os.path.join(run_dir, f"step_{N_LOSS_AT:010d}")
        shard_mb = [os.path.getsize(os.path.join(d_loss, f)) / 1e6
                    for f in ("shard000-of-002.npz", "shard001-of-002.npz")]
        whole_mb = os.path.getsize(os.path.join(
            run_dir, f"step_{ITERS:010d}", "arrays.npz")) / 1e6
        st_ = dict(r0["stamps"])
        quiesce = (r0["marks"]["host_lost"] - st_[N_LOSS_AT]) * 1e3
        tm = r0["timing"]
        before = (N_LOSS_AT - CHUNK) / (st_[N_LOSS_AT] - st_[CHUNK])
        after = (ITERS - N_LOSS_AT - CHUNK) / (st_[ITERS]
                                               - st_[N_LOSS_AT + CHUNK])
        first_ms = (st_[N_LOSS_AT + CHUNK] - r0["marks"]["remesh"]) * 1e3
        fs = dict(r0["fresh_stamps"])
        fresh = (ITERS - N_LOSS_AT - CHUNK) / (fs[ITERS]
                                               - fs[N_LOSS_AT + CHUNK])
        log(f"[n1] mnist-70k on 2 gloo ranks on cuda:0 as 2 simulated hosts, "
            f"host 1 lost at step {N_LOSS_AT}: events host_lost -> remesh to "
            f"{rm['mesh']} ({rm['n_devices']} rank, {rm['n_hosts']} host), "
            f"step {r0['step']} reached, Y finite; recall@32 {rec_n:.4f} "
            f"(phase (d) {rec_d:.4f}, (m) (2,1) {q_m[0]:.4f}), AUC "
            f"{auc_n:.4f} (phase (d) {auc_d:.4f}, (m) (2,1) {q_m[1]:.4f}); "
            f"bit for bit the one-rank fit_elastic resumed from a copy of "
            f"step {rm['step']}; {t_n1:.1f}s with the spawn")
        log(f"    host ms: quiesce (writes landed, barrier) {quiesce:.1f}, "
            f"remesh {tm['remesh'][-1]:.2f}, restore {tm['restore'][-1]:.1f} "
            f"(its verify {tm['verify'][-1]:.1f}), the fsck of "
            f"{len(steps)} boundaries {t_fsck:.1f} ({t_fsck / len(steps):.1f}"
            f" a boundary); shards at step {N_LOSS_AT} "
            + " + ".join(f"{m_:.2f}" for m_ in shard_mb)
            + f" MB, one host's arrays.npz {whole_mb:.2f} MB; steps redone "
            f"{hl['step'] - rm['step']}; steps/s at (2,1) {before:.1f} a "
            f"rank, at (1,1) after the loss {after:.1f} (its first chunk "
            f"{first_ms:.0f} ms from the remesh), the fresh one-rank run "
            f"{fresh:.1f}; launches rank 0 {r0['launches']}, rank 1 "
            f"{r1['launches']}")
        log(f"    fsck: {' | '.join(fsck.getvalue().strip().splitlines())}")

        # (n2) a real SIGKILL under the supervisor, and the same unkilled
        Xb = torch.from_numpy(synthetic.blobs(
            n=N, dim=DIM, n_centers=2, center_std=5.0, seed=0)[0]).to(dev)
        cfg_b = funcsne.FuncSNEConfig(n_points=N, dim_hd=DIM, n_negatives=4)
        true_b, _ = knn.exact_knn(Xb, cfg_b.k_hd, rows=rows)
        like = funcsne.init_state(Xb, cfg_b, seed=0, device=dev)
        rec_b0 = recall_of(like.hd_idx[rows], true_b)
        runs = {}
        for label, kill in (("killed", True), ("unkilled", False)):
            sup = control.Supervisor(
                os.path.join(root, label), n_pods=2, n=N, dim=DIM,
                n_iter=ITERS, chunk_size=CHUNK, device=dev.type,
                kill_pod=1 if kill else None,
                kill_at_chunk=N_KILL_AT if kill else None,
                total_timeout=N_TIMEOUT)
            t0 = time.monotonic()
            report = sup.run()
            wall = time.monotonic() - t0
            tree, meta = Checkpointer(sup.ckpt_dir).restore(like)
            check(meta["step"] == ITERS, f"(n2) {label}: final {meta}")
            runs[label] = {"sup": sup, "report": report, "wall": wall,
                           "recall": recall_of(tree.hd_idx[rows], true_b),
                           "auc": float(embedding_quality(Xb[sub],
                                                          tree.Y[sub]))}
            del tree
        k_, u_ = runs["killed"], runs["unkilled"]
        restore = faults.check_process_kill(k_["sup"], k_["report"], ITERS)
        check(u_["report"]["generations"] == 1
              and u_["report"]["result"]["step"] == ITERS
              and u_["report"]["result"]["finite"],
              f"(n2) unkilled: {u_['report']['result']}")
        trail = k_["report"]["trail"]

        def first(kind, **kw):
            return next(e for e in trail if e["kind"] == kind
                        and all(e.get(a) == b for a, b in kw.items()))
        kill_ev = first("process_kill")
        done = first("worker_done", generation=1)
        la = done["launches"]
        check(set(la) == expected
              and la["ne_forces_scatter"] == ITERS - restore["step"],
              f"(n2) the relaunched worker launched {la}")
        for e in u_["report"]["trail"]:
            if e["kind"] == "worker_done":
                check(set(e["launches"]) == expected,
                      f"(n2) unkilled pod {e['pod']} launched "
                      f"{e['launches']}")
        ratio = k_["report"]["result"]["y_std"] / \
            u_["report"]["result"]["y_std"]
        check(SPREAD_RANGE[0] <= ratio <= SPREAD_RANGE[1],
              f"(n2) spread ratio {ratio}")
        t_k = kill_ev["t"]
        cost = {name: (first(kind, **kw)["t"] - t_k) * 1e3
                for name, kind, kw in (
                    ("heartbeat_lost", "heartbeat_lost", {}),
                    ("generation_killed", "generation_killed", {}),
                    ("worker_start", "worker_start", {"generation": 1}),
                    ("restore", "restore", {"generation": 1}),
                    ("first boundary", "pod_started", {"generation": 1}))}
        log(f"[n2] blobs {N:,} x {DIM} under the supervisor, 2 workers on "
            f"cuda:0 (gloo), pod 1 SIGKILLed at step {kill_ev['step']}: "
            f"every check of scenario_process_kill passed (2 generations, "
            f"survivors [0], no orphan, no stale shard, final generation 1); "
            f"resumed at step {restore['step']} (steps redone "
            f"{kill_ev['step'] - restore['step']}); the relaunched worker "
            f"launched {la}; spread ratio {ratio:.4f} (killed / unkilled "
            f"y_std, within {SPREAD_RANGE})")
        log("    the kill's cost from the SIGKILL, ms on the trail's clock: "
            + ", ".join(f"{k} {v:.0f}" for k, v in cost.items())
            + f"; wall killed {k_['wall']:.1f}s against unkilled "
            f"{u_['wall']:.1f}s ({k_['wall'] / u_['wall']:.2f}x)")
        log(f"    recall@32 killed {k_['recall']:.4f} / unkilled "
            f"{u_['recall']:.4f} (initial lists {rec_b0:.5f}); AUC killed "
            f"{k_['auc']:.4f} / unkilled {u_['auc']:.4f}; ({card})")
        del like, Xb
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[n] phase (n) took {time.perf_counter() - t_n:.1f}s")


def resilience_phase(X, labels, cfg, hp, st_d, sps_d, recall, main_kernels,
                     hd_key, ld_key, card):
    """Phase (l), resilience-70k (see the module docstring): ``st_d`` is
    phase (d)'s final state, ``sps_d`` its steps/s, ``recall`` its recall
    of HD lists on a fixed subsample."""
    import shutil
    import statistics
    import tempfile

    from repro_torch import kernels
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import funcsne
    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.examples import dynamic_stream
    from repro_torch.kernels import fallback
    from repro_torch.runtime import faults

    t_l = time.perf_counter()
    dev = X.device
    check(fallback.n_events() == 0 and fallback.demotions() == {},
          f"a kernel family was demoted before phase (l): {fallback.events()}")
    b2_keys = (hd_key["knn_merge_cand"], ld_key["knn_merge_cand"])
    src = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip-smoke-ck-")

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def policy(name, **kw):
        kw.setdefault("sticky_fallback", False)
        return ResiliencePolicy(checkpoint_dir=os.path.join(root, name),
                                checkpoint_every=2, **kw)

    def timed_fit(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = funcsne.fit(X, cfg=cfg, n_iter=ITERS, chunk_size=CHUNK,
                             hparams=hp, device=dev, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def unexpected(pol, allowed=("straggler", "early_checkpoint")):
        return [e for e in pol.events if e["kind"] not in allowed]

    try:
        # the clean run, beside a plain fit of this call and a policy run
        # without checkpoints (its clone, read and audit alone; all three
        # with init)
        _, t_plain = timed_fit()
        st_a, t_nock = timed_fit(resilience=ResiliencePolicy(
            audit_every=5, sticky_fallback=False))
        check(same(st_a, st_d), "the policy run without checkpoints "
              "differs from phase (d)'s state")
        del st_a
        pol_c = policy("clean", audit_every=5)
        kernels.reset_launches()
        st_c, t_clean = timed_fit(resilience=pol_c)
        launches_c = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
        check(same(st_c, st_d), "resilience-70k: the clean policy run "
              "differs from phase (d)'s state")
        check(not unexpected(pol_c), f"clean run events {pol_c.events}")
        check(fallback.demotions() == {}, "clean run demoted a kernel")
        check(set(launches_c) == main_kernels,
              f"clean run launched {launches_c}")
        steps_c = Checkpointer(pol_c.checkpoint_dir).all_steps()
        check(steps_c and steps_c[-1] == ITERS, f"clean run steps {steps_c}")
        log(f"[l] clean run: fit(resilience=ResiliencePolicy(checkpoint_"
            f"every=2, audit_every=5)) bit for bit phase (d)'s state; "
            f"{len(pol_c.events)} events ({[e['kind'] for e in pol_c.events]}),"
            f" no demotion; committed steps {steps_c} (keep_last 3); "
            f"launches {launches_c}")
        log(f"[l] steps/s: policy run {ITERS / t_clean:.1f}, without its "
            f"checkpoints {ITERS / t_nock:.1f}, plain fit "
            f"{ITERS / t_plain:.1f} (all with init_state), phase (d)'s "
            f"chunks {sps_d:.1f}; the policy's cost {t_clean - t_plain:+.3f}s"
            f" over {ITERS} steps, {t_nock - t_plain:+.3f}s without its "
            f"checkpoints ({card})")

        # what a checkpoint costs at n = 70,000: save() on the host (the
        # copy to the host; the write runs on a thread), the bytes, the
        # thread's write (wait), a verified restore onto the card, one
        # step's verification
        ck = Checkpointer(os.path.join(root, "timing"), keep_last=2)
        meta = {"lr_scale": 1.0, "ex_scale": 1.0}
        save_ms, wait_ms, rest_ms, ver_ms = [], [], [], []
        for r in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(ITERS + r, funcsne._checkpoint_state(st_c), metadata=meta)
            t1 = time.perf_counter()
            ck.wait()
            t2 = time.perf_counter()
            save_ms.append((t1 - t0) * 1e3)
            wait_ms.append((t2 - t1) * 1e3)
            t0 = time.perf_counter()
            got, _, fbs = ck.restore_verified(st_c)
            torch.cuda.synchronize()
            rest_ms.append((time.perf_counter() - t0) * 1e3)
            check(same(got, st_c) and not fbs, "restore differs")
            t0 = time.perf_counter()
            ck.verify_step(ITERS + r)
            ver_ms.append((time.perf_counter() - t0) * 1e3)
        d_last = ck.dir / f"step_{ITERS + 4:010d}"
        n_bytes = sum(f.stat().st_size for f in d_last.iterdir())
        npz = (d_last / "arrays.npz").stat().st_size
        med = statistics.median
        log(f"[l] checkpoint at n={N}: save {med(save_ms):.2f} ms on the "
            f"host (median of 5, the write async), {n_bytes} bytes a step "
            f"({npz} in arrays.npz), wait {med(wait_ms):.2f} ms, restore "
            f"(verified, onto the card) {med(rest_ms):.2f} ms, verify "
            f"{med(ver_ms):.2f} ms a step ({card})")
        del got

        # a NaN chunk: one rollback, the backoff logged, Y finite
        pol_n = policy("nan")
        with faults.active(faults.FaultScript(
                faults.NaNChunk(at_step=L_NAN_CHUNK * CHUNK))):
            st_n, t_n = timed_fit(resilience=pol_n)
        rb = [e for e in pol_n.events if e["kind"] == "rollback"]
        check(len(rb) == 1 and rb[0]["step"] == L_NAN_CHUNK * CHUNK,
              f"NaN chunk: events {pol_n.events}")
        check(not unexpected(pol_n, ("rollback", "straggler",
                                     "early_checkpoint")),
              f"NaN chunk: events {pol_n.events}")
        check(int(st_n.step) == ITERS and bool(torch.isfinite(st_n.Y).all()),
              "NaN chunk: the run did not finish finite")
        rec_n = recall(st_n.hd_idx)
        log(f"[l] NaN chunk at step {L_NAN_CHUNK * CHUNK}: one rollback "
            f"({rb[0]['reason'][:60]}...), lr_scale {rb[0]['lr_scale']}, "
            f"ex_scale {rb[0]['ex_scale']}; Y finite, recall {rec_n:.4f}; "
            f"{ITERS / t_n:.1f} steps/s with the retried chunk")
        del st_n

        # preemption, then resume: bit for bit the uninterrupted run
        at = L_PREEMPT_CHUNK * CHUNK
        pol_p = policy("preempt")
        try:
            with faults.active(faults.FaultScript(faults.Preemption(at))):
                timed_fit(resilience=pol_p)
            check(False, "the preemption did not fire")
        except faults.Preempted as e:
            killed = e.step
        steps_p = Checkpointer(pol_p.checkpoint_dir).all_steps()
        check(killed == at and steps_p[-1] == at,
              f"preempted at {killed}, committed {steps_p}")
        st_r, t_r = timed_fit(resilience=policy("preempt"),
                              resume_from=pol_p.checkpoint_dir)
        check(same(st_r, st_d), "the resumed run differs from phase (d)")
        log(f"[l] preempted at step {killed} (committed {steps_p}); "
            f"fit(resume_from=) ran steps {at}-{ITERS} in {t_r:.2f}s (init "
            f"and restore included) and ends bit for bit on phase (d)'s "
            f"state")
        del st_r

        # the newest boundary damaged at the preemption: the fsck reports
        # it, the resume falls back one boundary and replays exactly
        pol_x = policy("corrupt")
        shard = faults.CorruptShard(at_step=at, mode="bitflip")
        try:
            with faults.active(faults.FaultScript(shard,
                                                  faults.Preemption(at))):
                timed_fit(resilience=pol_x)
            check(False, "the preemption did not fire")
        except faults.Preempted:
            pass
        check(shard.damaged is not None, "CorruptShard did not fire")
        env = dict(os.environ, PYTHONPATH=os.path.join(src, "src"))
        t0 = time.perf_counter()
        fsck = subprocess.run(
            [sys.executable, "-m", "repro_torch.checkpoint.verify",
             pol_x.checkpoint_dir], capture_output=True, text=True, env=env,
            timeout=300)
        t_fsck = time.perf_counter() - t0
        lines = fsck.stdout.strip().splitlines()
        check(fsck.returncode == 1 and lines[-1].startswith(
            f"step {at}: CORRUPT -- arrays.npz: CRC32 mismatch")
            and all(": OK (1 shard file(s), n_hosts=1)" in ln
                    for ln in lines[:-1]),
              f"fsck exit {fsck.returncode}: {fsck.stdout} {fsck.stderr}")
        pol_xr = policy("corrupt")
        st_x, _ = timed_fit(resilience=pol_xr,
                            resume_from=pol_x.checkpoint_dir)
        fbs = [e for e in pol_xr.events if e["kind"] == "checkpoint_fallback"]
        check([f["step"] for f in fbs] == [at],
              f"damaged resume: events {pol_xr.events}")
        check(same(st_x, st_d), "the resume past a damaged boundary differs "
              "from phase (d)")
        log(f"[l] damaged boundary {at} (one bit flipped): python -m "
            f"repro_torch.checkpoint.verify exit {fsck.returncode} (the "
            f"reference's 1) in {t_fsck:.2f}s: "
            + " | ".join(lines) + f"; the resume logged checkpoint_fallback"
            f" from {at}, restored step {at - 2 * CHUNK}, and ends bit for "
            f"bit on phase (d)'s state")
        del st_x

        # a kernel fault under sticky_fallback: on the card it surfaces
        # from fit as a kernel_fault event, with nothing demoted (no plain
        # version runs on CUDA tensors), and the run resumes from its last
        # committed boundary
        pol_k = policy("kernel", sticky_fallback=True)
        fault = faults.KernelLaunchFault("knn_merge",
                                         at_launch=L_FAULT_LAUNCH)
        kernels.reset_launches()
        try:
            with faults.active(faults.FaultScript(fault)):
                timed_fit(resilience=pol_k)
            check(False, "kernel fault: fit did not raise")
        except faults.InjectedKernelFault as e:
            raised = str(e)
        launches_k = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
        kinds_k = [e["kind"] for e in pol_k.events]
        ev = [e for e in pol_k.events if e["kind"] == "kernel_fault"]
        check(fault.fired and fallback.demotions() == {}
              and "kernel_demoted" not in kinds_k and len(ev) == 1
              and ev[0]["family"] == "knn_merge",
              f"kernel fault: {fallback.demotions()} {pol_k.events}")
        b2 = sum(launches_k.get(k_, 0) for k_ in b2_keys)
        check(b2 == L_FAULT_LAUNCH and set(launches_k) <= main_kernels,
              f"kernel fault: B2 launched {b2} times, {L_FAULT_LAUNCH} "
              f"expected (every guarded call before the fault); launches "
              f"{launches_k}")
        steps_k = Checkpointer(pol_k.checkpoint_dir).all_steps()
        kernels.reset_launches()
        st_k, t_k = timed_fit(resilience=policy("kernel"),
                              resume_from=pol_k.checkpoint_dir)
        launches_kr = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
        check(same(st_k, st_d), "the run resumed past the kernel fault "
              "differs from phase (d)'s state")
        check(set(launches_kr) == main_kernels and fallback.demotions() == {},
              f"kernel fault resume: launches {launches_kr}")
        log(f"[l] KernelLaunchFault('knn_merge', at_launch={L_FAULT_LAUNCH})"
            f": fit raised InjectedKernelFault ({raised}) with one "
            f"kernel_fault event, no demotion; launches before it "
            f"{launches_k} (B2 stopped at {b2}); committed {steps_k}; "
            f"fit(resume_from=) ran steps {steps_k[-1]}-{ITERS} in "
            f"{t_k:.2f}s, launches {launches_kr}, and ends bit for bit on "
            f"phase (d)'s state")
        fallback.reset()
        del st_k

        # the session example on X with session-70k's waves
        ids = torch.arange(N)
        waves = [torch.nonzero(ids % 3 == r)[:, 0].numpy() for r in range(3)]
        kernels.reset_launches()
        t0 = time.perf_counter()
        st_s, pol_s, report = dynamic_stream.run_session(
            X, labels, waves, n_iter=SESSION_ITERS,
            remove_iters=SESSION_REMOVE_ITERS, chunk_size=CHUNK,
            perplexity=float(hp.perplexity), ckdir=os.path.join(root, "stream"),
            sample=RECALL_ROWS, log=lambda ln: log(f"    {ln}"), device=dev)
        t_s = time.perf_counter() - t0
        launches_s = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
        check(set(launches_s) == main_kernels,
              f"dynamic_stream launched {launches_s}")
        check(report[-1]["finite"] and fallback.demotions() == {}
              and not unexpected(pol_s), f"dynamic_stream: {pol_s.events}")
        # far above the random lists' 32/70,000 (session-70k's recall of
        # all active rows fell to about 0.24 by its last wave)
        check(all(r["recall"] > 0.1 for r in report[:3]),
              f"dynamic_stream recalls {[r['recall'] for r in report[:3]]}")
        log(f"[l] dynamic_stream on X, waves of {[len(w) for w in waves]} "
            f"rows: recall@{cfg.k_hd} of {RECALL_ROWS} wave-0 rows after each "
            f"wave {[round(r['recall'], 4) for r in report[:3]]}, AUC "
            f"{[round(r['auc'], 4) for r in report[:3]]}; after the removal "
            f"{report[-1]['active']} active, Y finite; {len(pol_s.events)} "
            f"resilience events; {t_s:.1f}s in all")
        del st_s
    finally:
        fallback.reset()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[l] phase (l) took {time.perf_counter() - t_l:.1f}s")


def _o_config(name, **kw):
    """Phase (o)'s model config: the registered one with ``kw`` replaced."""
    from repro_torch.configs.base import get_arch
    return dataclasses.replace(get_arch(name), **kw)


def _tree_bytes(tree, per=lambda t: t.numel() * t.element_size()):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, per) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v, per) for v in tree)
    return per(tree)


def _b8_model_row(name, call, launches, reps, tag, route, simt_too=False):
    """B8 at a model path's shape (the first call of its kind, recorded on
    that path): its kernel (``route``, the one ``kernel_route`` names)
    held against the plain ``flash_chunked_ref``, timed with CUDA events
    beside the plain version and, without softcap or window, SDPA (which
    takes Dv != D too).  ``simt_too``: the SIMT kernel at the same shape
    also held and timed, a row of its own with 0 launches (timing only).
    The bound counts 2 B Hq (D + Dv) flops a kept (row, col) pair at the
    bf16 rate.  Returns the rows of the ``kernels`` line."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.attention import flash_chunked, flash_chunked_ref
    q, k, v, kw = call
    b, s_len, hq, d = q.shape
    dv = v.shape[-1]
    got_route = flash_ops.kernel_route(q.dtype, d, dv)
    check(got_route == route and q.dtype == torch.bfloat16,
          f"{name}: B8 route {got_route}, {q.dtype}")
    want = flash_chunked_ref(q, k, v, **kw)
    calls = {route: lambda: flash_chunked(q, k, v, **kw)}
    if simt_too:
        out_s = torch.empty_like(want)
        kw_s = dict(scale=kw["scale"], softcap=kw["cap"],
                    window=kw["window"])

        def simt():
            flash_ops.launch_simt(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), out_s.transpose(1, 2),
                                  **kw_s)
            return out_s
        calls["simt"] = simt
    plain_ms = time_ms(lambda: flash_chunked_ref(q, k, v, **kw), 2)
    flops = 2.0 * b * hq * (d + dv) * attn_pairs(s_len, kw["window"])
    b_ms, b_by = bound(nbytes(q, k, v) + want.numel() * want.element_size(),
                       flops, BF16_FLOPS_PER_S)
    lib_ms = None
    if not kw["cap"] and not kw["window"]:
        qt, kt, vt = (t_.transpose(1, 2) for t_ in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True,
            scale=kw["scale"]), reps)
    rows = []
    for r, fn in calls.items():
        err = attn_close(fn(), want, f"{name} {B8_LABEL[r]}")
        ms = time_ms(fn, reps)
        row = name if r == route else f"{name}_{r}"
        n = launches if r == route else 0
        log(f"{tag} {row}: q {tuple(q.shape)} (B, S, H, D), v width {dv}, "
            f"{k.shape[2]} KV heads, softcap {kw['cap']}, window "
            f"{kw['window']}: the {B8_LABEL[r]} kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the "
            f"bound), bound {b_ms:.4f} ms by {b_by}, plain {plain_ms:.3f} ms"
            + ("" if lib_ms is None else f", SDPA {lib_ms:.4f} ms")
            + f"; max abs err {err:.3e} against the plain version; {n} "
            f"launches on the path" + ("" if n else " (timing only)"))
        rows.append({"name": row, "route": "cuda", "source": B8_SOURCE[r],
                     "replaces": B8_REPLACES, "launches": n,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})
    return rows


def _decode(model, params, cache, tokens, lo, hi, keep):
    """Teacher-forced ``serve_step`` over positions lo .. hi - 1 from
    ``cache``; returns the logits at the positions in ``keep`` (B, len,
    V) in float32 and the seconds it took.  Each step's ``cur_len`` is a
    0-d slice of one device tensor: the loop makes no host sync."""
    from repro_torch.launch.steps import make_serve_step
    step = make_serve_step(model)
    lens = torch.arange(1, hi + 1, dtype=torch.int32, device=tokens.device)
    keep, kept = set(keep), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(lo, hi):
        lg, cache = step(params, cache, tokens[:, t:t + 1], lens[t])
        if t in keep:
            kept.append(lg[:, 0].float())
    torch.cuda.synchronize()
    return torch.stack(kept, 1), time.perf_counter() - t0


def _vs_prefill(dec, full, scale):
    """Decode against prefill logits: max |difference| over ``scale`` (the
    largest |prefill logit|), relative Frobenius error, top-1 agreement."""
    diff = dec - full
    return (float(diff.abs().max()) / scale,
            float(diff.norm() / full.norm()),
            float((dec.argmax(-1) == full.argmax(-1)).float().mean()))


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_clone(v) for v in tree]
    return tree.clone()


def _planted_faults(model, params, snap, tokens, cut, n_dec, full, scale):
    """Two faults planted in Gemma2's decode, each held against the prefill
    like the sound run (``full``: the prefill's logits at the first O_FIRST
    and the last n_dec - cut positions):

    * the cache read one slot off: ``decode_attention`` sees each layer's
      K / V one slot later (position p at slot p + 1, as a write at
      ``cur_len`` would leave it), over positions 0 .. O_FIRST - 1 from a
      fresh cache;
    * the window mask off: the model with ``local_window = 0`` over
      positions cut .. n_dec - 1 from ``snap``, the sound run's cache
      before position cut, where the window starts to bite.

    Returns ``{fault: (max rel, Frobenius rel, top-1)}``."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.transformer import LMModel
    check(full.shape[1] == O_FIRST + n_dec - cut,
          f"prefill logits at {full.shape[1]} positions")
    sound = attn_lib.decode_attention

    def shifted(q, k_cache, v_cache, cur_len, **kw):
        return sound(q, k_cache.roll(1, dims=1), v_cache.roll(1, dims=1),
                     cur_len, **kw)
    cache = model.init_cache(tokens.shape[0], n_dec, device=tokens.device)
    attn_lib.decode_attention = shifted
    try:
        slot, _ = _decode(model, params, cache, tokens, 0, O_FIRST,
                          range(O_FIRST))
    finally:
        attn_lib.decode_attention = sound
    del cache
    unwindowed = LMModel(dataclasses.replace(model.cfg, local_window=0))
    win, _ = _decode(unwindowed, params, snap, tokens, cut, n_dec,
                     range(cut, n_dec))
    return {"cache slot + 1": _vs_prefill(slot, full[:, :O_FIRST], scale),
            "window mask off": _vs_prefill(win, full[:, O_FIRST:], scale)}


def _device_ms(prof, per=1):
    """{name: (device ms / ``per``, events)} of a profile's device events,
    summed by name as they come: building ``key_averages``' event tree of
    a long trace takes seconds."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, cnt = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6 / per, cnt + 1)
    return by_name


def _top(by_name, n=6):
    """The ``n`` names of ``_device_ms`` with the most device time, as
    (name, ms, events)."""
    return sorted(((k, ms, cnt) for k, (ms, cnt) in by_name.items()),
                  key=lambda r: -r[1])[:n]


def _prefill_busy(model, params, tokens):
    """A second, warm ``hidden_states`` under the profiler (device activity
    only): device busy ms, the profiled wall ms, B8's device ms and events
    (kernels whose name holds ``flash_``) and the top kernels by device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.hidden_states(params, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = _device_ms(prof)
    busy = sum(ms for ms, _ in by_name.values())
    check(busy > 0, "the profiler recorded no kernel of the prefill")
    b8 = [(ms, cnt) for k, (ms, cnt) in by_name.items() if "flash_" in k]
    return (busy, wall, sum(ms for ms, _ in b8), sum(c for _, c in b8),
            _top(by_name, 4))


def _decode_busy(model, params, tokens, max_len):
    """O_PROFILE decode steps from a fresh cache under the profiler (device
    activity): device busy ms a step (kernel time), the profiled wall ms a
    step, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_serve_step
    step = make_serve_step(model)
    cache = model.init_cache(tokens.shape[0], max_len, device=tokens.device)
    lens = torch.arange(1, O_PROFILE + 1, dtype=torch.int32,
                        device=tokens.device)
    step(params, cache, tokens[:, :1], lens[0])
    torch.cuda.synchronize()
    # device activity only: a decode step issues thousands of host ops
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(O_PROFILE):
            step(params, cache, tokens[:, t:t + 1], lens[t])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / O_PROFILE * 1e3
    by_name = _device_ms(prof, O_PROFILE)
    busy = sum(ms for ms, _ in by_name.values())
    check(busy > 0, "the profiler recorded no kernel of the decode steps")
    return busy, wall, _top(by_name)


def serve_model(name, cfg, batch, s_len, n_dec, keep, tag, dev, *,
                b8_route="wgmma", b8_count=None, simt_too=False,
                faults=None, tol=TOL_DECODE, tol_h=TOL_LATENTS):
    """One model of phases (o) and (p): ``init_params`` on the card;
    ``hidden_states`` of ``batch`` x ``s_len`` seeded tokens through B8
    (launch counters at 0 just before: B8's ``b8_route`` kernel
    ``b8_count`` times, default once a layer, nothing else) and, where B8
    runs, through the plain ``flash_chunked_ref`` and once more under the
    profiler (``_prefill_busy``); B8 held and timed at
    each of the path's attention shapes (``_b8_model_row``; ``simt_too``:
    the SIMT kernel beside it); teacher-forced decode of ``n_dec``
    positions from ``init_cache(batch, n_dec)`` held against the prefill's
    logits at the positions ``keep`` (``tol``; for Gemma2 also TOP1_MIN);
    the planted ``faults`` (``_planted_faults`` or ``_p_faults``) each
    read above ``tol``; decode tokens/s, the busy share of O_PROFILE
    steps, the cache bytes and the peak memory.  Returns ``(rows, model,
    params, tokens)``."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.models.attention import flash_chunked, flash_chunked_ref
    from repro_torch.models.transformer import LMModel
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LMModel(cfg)
    params = model.init_params(0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_par = _tree_bytes(params, per=torch.Tensor.numel)
    b8_count = cfg.n_layers if b8_count is None else b8_count
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        + (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
           f"{cfg.resolved_head_dim}, " if cfg.n_heads else "")
        + (f"MLA (kv_lora {cfg.kv_lora_rank}, q_nope {cfg.q_nope_dim}, "
           f"q_rope {cfg.q_rope_dim}, v {cfg.v_head_dim}), "
           if cfg.is_mla else "")
        + (f"SSD (state {cfg.ssm_state}, {cfg.ssm_nheads} heads of "
           f"{cfg.ssm_headdim}, chunk {cfg.ssm_chunk}"
           + (f", the shared block every {cfg.shared_attn_every}"
              if cfg.shared_attn_every else "") + "), "
           if cfg.ssm_state else "")
        + f"vocab {cfg.vocab_size}"
        + (f", {cfg.n_experts} experts top-{cfg.moe_top_k} of d_ff "
           f"{cfg.d_ff_expert}, {cfg.n_shared_experts} shared, capacity "
           f"factor {cfg.capacity_factor}"
           if cfg.is_moe else f", d_ff {cfg.d_ff}")
        + f"; {cfg.param_dtype} params ({n_par / 1e9:.3f} B, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), "
        f"{cfg.compute_dtype} compute; init_params(0) by threefry on the "
        f"card in {t_init:.1f}s")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, s_len))).to(dev)

    calls, counts = {}, {}

    def rec(q, k, v, **kw):
        kind = "local" if kw["window"] else "global"
        calls.setdefault(kind, (q, k, v, kw))
        counts[kind] = counts.get(kind, 0) + 1
        return flash_chunked(q, k, v, **kw)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = LMModel(cfg, attention=rec).hidden_states(params, tokens)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {f"flash_attention_{b8_route}": b8_count} if b8_count else {}
    check(launches == {k_: want.get(k_, 0) for k_ in launches},
          f"{cfg.name} hidden_states launches "
          f"{ {k_: v_ for k_, v_ in launches.items() if v_} }, expected "
          f"{want}")
    check(sum(counts.values()) == b8_count, f"B8 calls {counts}")
    check(bool(torch.isfinite(h).all()), f"{cfg.name} hidden states")
    if b8_count:
        h_p = LMModel(cfg, attention=flash_chunked_ref).hidden_states(
            params, tokens)
        rel_h = float((h.float() - h_p.float()).norm() / h_p.float().norm())
        check(rel_h <= tol_h,
              f"{cfg.name} hidden states, B8 vs plain: {rel_h}")
        del h_p
        busy_p, wall_p, b8_ms, b8_n, top_p = _prefill_busy(model, params,
                                                           tokens)
        check(b8_n == b8_count, f"{cfg.name}: {b8_n} B8 kernels in the "
              f"profiled prefill, expected {b8_count}")
        vs = (f"B8's {B8_LABEL[b8_route]} kernel launched {b8_count} times "
              f"({', '.join(f'{k_} {v_}' for k_, v_ in sorted(counts.items()))}"
              f"), nothing else; {rel_h:.3e} from the plain flash_chunked's "
              f"(relative Frobenius, tol {tol_h})")
    else:
        vs = "no kernel of the port launched (no attention; SSD is plain)"
    log(f"{tag} hidden_states of {batch} x {s_len} tokens: {t_pre:.2f}s "
        f"({batch * s_len / t_pre:.0f} tokens/s); {vs}")
    if b8_count:
        log(f"{tag} profiler, a second (warm) hidden_states: device busy "
            f"{busy_p:.2f} ms against {wall_p:.2f} ms of profiled wall "
            f"({busy_p / wall_p:.1%}); B8 {b8_ms:.3f} ms in {b8_n} kernels "
            f"({b8_ms / busy_p:.1%} of the device time); device time by "
            f"kernel:")
        for key, ms, cnt in top_p:
            log(f"    {ms:9.4f} ms  {cnt:6d}x  {key[:90]}")
    rows = [r_ for kind, call in sorted(calls.items())
            for r_ in _b8_model_row(f"flash_attention_{name}" + (
                f"_{kind}" if len(calls) > 1 else ""), call, counts[kind], 5,
                tag, b8_route, simt_too)]
    del calls

    idx = torch.tensor(sorted(keep), device=dev)
    full = model._logits_fn(params)(h[:, idx]).float()
    if cfg.final_softcap:
        full = cfg.final_softcap * torch.tanh(full / cfg.final_softcap)
    del h
    cache = model.init_cache(batch, n_dec, device=dev)
    cache_bytes = _tree_bytes(cache)
    # Gemma2: the cache is copied before the last O_LAST positions, where
    # the window starts to bite, for the planted window fault
    cut = n_dec - O_LAST if cfg.local_window else n_dec
    kernels.reset_launches()
    dec, t_dec = _decode(model, params, cache, tokens, 0, cut, keep)
    snap = _tree_clone(cache) if cut < n_dec else None
    if snap is not None:
        dec_b, t_b = _decode(model, params, cache, tokens, cut, n_dec, keep)
        dec, t_dec = torch.cat([dec, dec_b], 1), t_dec + t_b
        del dec_b
    launches_dec = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
    check(not launches_dec, f"decode launched {launches_dec}")
    check(bool(torch.isfinite(dec).all()), f"{cfg.name} decode logits")
    del cache
    pos = sorted(keep)
    spans = [(f"positions {a}-{b}", [i for i, p in enumerate(pos)
                                     if a <= p <= b])
             for a, b in _spans(pos)]
    scale = float(full.abs().max())
    parts = []
    for label, sel in spans:
        rel, frob, top1 = _vs_prefill(dec[:, sel], full[:, sel], scale)
        check(rel <= tol, f"{cfg.name} decode vs prefill at {label}: {rel}")
        check(snap is None or top1 >= TOP1_MIN,
              f"{cfg.name} decode vs prefill at {label}: top-1 {top1}")
        parts.append(f"{label}: max rel err {rel:.3e}, Frobenius "
                     f"{frob:.3e}, top-1 agreement {top1:.4f}")
    del dec
    if faults is not None:
        read = faults(model, params, snap, tokens, cut, n_dec, full, scale)
        del snap
        log(f"{tag} planted faults against the prefill (each must exceed "
            f"tol {tol}): " + "; ".join(
                f"{k_}: max rel err {r_:.3e}, Frobenius {f_:.3e}, top-1 "
                f"{t_:.4f}" for k_, (r_, f_, t_) in read.items()))
        for k_, (r_, _, _) in read.items():
            check(r_ > tol, f"{cfg.name} planted fault {k_} read {r_}, "
                  f"within the bound {tol}")
    del full
    ms_step = t_dec / n_dec * 1e3
    busy, wall, top = _decode_busy(model, params, tokens, n_dec)
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} teacher-forced serve_step over {n_dec} positions from "
        f"init_cache({batch}, {n_dec}) (bf16, {cache_bytes / 1e9:.3f} GB): "
        f"{t_dec:.2f}s, {ms_step:.3f} ms a step, {batch * n_dec / t_dec:.1f} "
        f"tokens/s; no kernel of the port launched (decode is plain, as in "
        f"the reference); against the prefill's logits (tol {tol}): "
        + "; ".join(parts))
    log(f"{tag} profiler, {O_PROFILE} decode steps: device busy {busy:.3f} "
        f"ms a step against {wall:.3f} ms of profiled wall ({busy / wall:.1%})"
        f" and {ms_step:.3f} ms unprofiled ({busy / ms_step:.1%}); peak "
        f"memory {peak / 1e9:.2f} GB; device time by kernel a step:")
    for key, ms, cnt in top:
        log(f"    {ms:9.4f} ms  {cnt / O_PROFILE:6.1f}x  {key[:90]}")
    return rows, model, params, tokens


def _spans(pos):
    """Runs of consecutive positions in the sorted list ``pos``."""
    out, a = [], pos[0]
    for p_, q_ in zip(pos, pos[1:] + [None]):
        if q_ != p_ + 1:
            out.append((a, p_))
            a = q_
    return out


def serve_moe_checks(model, params, tokens, tag):
    """OLMoE's routed experts on the card: ``dropped_frac`` of the batch
    at the default capacity factor 1.25, and ``moe_apply`` on layer 0's
    tokens run twice, bit-identical, beside the same combine by
    ``index_add_`` (atomics: printed, not held)."""
    from repro_torch.models import moe
    from repro_torch.models.blocks import _norm
    from repro_torch.models.common import dtype_of, matmul_cd, swiglu
    from repro_torch.models.transformer import LMModel
    cfg = model.cfg
    m125 = LMModel(dataclasses.replace(cfg, capacity_factor=1.25))
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    _, _, aux = m125._run_stack(params, m125._embed_in(params, tokens),
                                positions=pos)
    drop = float(aux["dropped_frac"])
    check(0.0 <= drop < 1.0, f"dropped_frac at 1.25: {drop}")
    blk = params["blocks"][0]
    x = _norm(blk["ln_mlp"], model._embed_in(params, tokens), cfg).reshape(
        -1, cfg.d_model)
    o1, _ = moe.moe_apply(blk["ffn"], x, cfg)
    o2, _ = moe.moe_apply(blk["ffn"], x, cfg)
    same = torch.equal(o1.view(torch.int16), o2.view(torch.int16))
    check(same, "moe_apply twice on one input differs")
    ms_moe = time_ms(lambda: moe.moe_apply(blk["ffn"], x, cfg), 5)
    # the combine alone, and the same sum by index_add_
    T, k, E = x.shape[0], cfg.moe_top_k, cfg.n_experts
    cd = dtype_of(cfg.compute_dtype)
    C = moe.moe_capacity(T, E, k, cfg.capacity_factor)
    r = moe.plan(x, blk["ffn"]["router"], k, C)
    buf = moe.dispatch(x, r["order"], r["starts"], r["counts"], k, C, cd)
    out_e = matmul_cd(swiglu(matmul_cd(buf, blk["ffn"]["w_gate"].to(cd)),
                             matmul_cd(buf, blk["ffn"]["w_up"].to(cd))),
                      blk["ffn"]["w_down"].to(cd))
    pos_tk = torch.empty_like(r["pos"])
    pos_tk[r["order"]] = r["pos"]
    pos_tk = pos_tk.view(T, k)

    def comb():
        return moe.combine(out_e, r["top_e"], r["top_p"], pos_tk, cd)
    c1, c2 = comb(), comb()
    check(torch.equal(c1.view(torch.int16), c2.view(torch.int16)),
          "the combine twice on one input differs")
    se = r["top_e"].reshape(-1)[r["order"]]
    contrib = out_e[se, r["pos"].clamp(0, C - 1)] * (
        r["top_p"].reshape(-1)[r["order"]] * r["keep"]).to(cd)[:, None]
    tok = r["order"] // k

    def lib():
        return torch.zeros((T, cfg.d_model), dtype=cd,
                           device=x.device).index_add_(0, tok, contrib)
    l1, l2 = lib(), lib()
    ms_comb, ms_lib = time_ms(comb, 10), time_ms(lib, 10)
    log(f"{tag} dropped_frac of the {tokens.shape[0]} x {tokens.shape[1]} "
        f"batch at capacity factor 1.25: {drop:.4f} (mean over layers); "
        f"moe_apply on layer 0's {T} tokens twice: bit-identical, "
        f"{ms_moe:.3f} ms a call; the combine (ascending expert id, {k} adds "
        f"in bf16) twice bit-identical, {ms_comb:.4f} ms; index_add_ of the "
        f"same contributions {ms_lib:.4f} ms, its two runs "
        f"{'bit-identical' if torch.equal(l1, l2) else 'differ'}, "
        f"{float((l1.float() - c1.float()).abs().max()):.3e} from the "
        f"combine at most")


def serve_examples(dev):
    """A7's examples at the reference's sizes on the card, each with the
    launch counters at 0 just before (B3 once a step), beside the numbers
    the JAX examples print on the CPU."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.examples import (hierarchy_graph, interactive_hparams,
                                      quickstart)

    def sub(msg):
        for line in str(msg).splitlines():
            log(f"    {line}")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            q = quickstart.run(log=sub, device=dev)
            t_q = time.perf_counter() - t0
            wrote = os.path.exists(quickstart.OUT)
        finally:
            os.chdir(cwd)
    b3 = kernels.LAUNCHES["ne_forces_scatter"]
    check(wrote and b3 == 750, f"quickstart: wrote {wrote}, B3 {b3}")
    check(q["hd_knn"] > 0.9 and q["one_nn"] > 0.9 and q["embedding"] > 0.1,
          f"quickstart qualities {q}")
    log(f"[o3] quickstart: {t_q:.1f}s (fit of 750 steps, B3 launched {b3} "
        f"times); HD KNN {q['hd_knn']:.3f}, embedding {q['embedding']:.3f}, "
        f"1-NN {q['one_nn']:.3f}; the JAX example on the CPU: "
        + ", ".join(f"{v:.3f}" for v in JAX_QUICKSTART.values()))

    kernels.reset_launches()
    _, report, builds = interactive_hparams.run(log=sub, device=dev)
    b3 = kernels.LAUNCHES["ne_forces_scatter"]
    steps = sum(interactive_hparams.ITERS)
    check(builds == 0 and b3 == steps,
          f"interactive_hparams: builds {builds}, B3 {b3}")
    clusters = [r["clusters"] for r in report]
    check(clusters[2] > 2 * max(clusters[:2] + clusters[3:]),
          f"interactive_hparams: clusters {clusters}, alpha 0.5 does not "
          f"fragment them")
    log(f"[o3] interactive_hparams: " + ", ".join(
        f"{r['it_s']:.0f} it/s {r['clusters']} clusters" for r in report)
        + f"; kernel library builds after phase 1: {builds}; B3 launched "
        f"{b3} times; the JAX example's clusters on the CPU: "
        f"{list(JAX_INTERACTIVE)}")

    kernels.reset_launches()
    t0 = time.perf_counter()
    graph, counts, strong = hierarchy_graph.run(log=sub, device=dev)
    t_h = time.perf_counter() - t0
    b3 = kernels.LAUNCHES["ne_forces_scatter"]
    check(b3 == 1200 and len(counts) == 3 and min(counts) >= 1,
          f"hierarchy_graph: counts {counts}, B3 {b3}")
    log(f"[o3] hierarchy_graph: {t_h:.1f}s, cluster counts {counts}, "
        f"{len(strong)} strong edges; B3 launched {b3} times; the JAX "
        f"example on the CPU: {JAX_HIERARCHY[0]}, {JAX_HIERARCHY[1]} strong "
        f"edges")


def _patched_decode(model, params, tokens, n_dec, full, scale, mod, attr,
                    fn):
    """Decode positions 0 .. n_dec - 1 from a fresh cache with ``mod.attr``
    replaced by ``fn``, held against the prefill's logits ``full`` as the
    sound run (``_vs_prefill``)."""
    sound = getattr(mod, attr)
    cache = model.init_cache(tokens.shape[0], n_dec, device=tokens.device)
    setattr(mod, attr, fn)
    try:
        dec, _ = _decode(model, params, cache, tokens, 0, n_dec,
                         range(n_dec))
    finally:
        setattr(mod, attr, sound)
    return _vs_prefill(dec, full, scale)


def _p_faults(model, params, snap, tokens, cut, n_dec, full, scale):
    """Phase (p)'s planted fault, over every decoded position from a fresh
    cache: for MLA the latent pair written one slot off (at ``cur_len``,
    clamped, where the sound step writes ``cur_len - 1``: the new token's
    latent lies under the mask, each earlier one a slot late); for Mamba2
    and Zamba2 the SSM state not decayed (``exp(dt A)`` replaced by 1).
    Returns ``{fault: (max rel, Frobenius rel, top-1)}``."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import mamba2 as mamba_lib
    del snap, cut
    if model.cfg.is_mla:
        def late(cur_len, smax):
            return cur_len.reshape(1).clamp(0, smax - 1).long()
        return {"latent cache slot + 1": _patched_decode(
            model, params, tokens, n_dec, full, scale, attn_lib,
            "cache_slot", late)}

    def kept(dt, A):
        return torch.ones_like(dt * A[None, :])
    return {"ssm state not decayed": _patched_decode(
        model, params, tokens, n_dec, full, scale, mamba_lib,
        "_state_decay", kept)}


def serve_ssd_check(model, params, tokens, tag):
    """(p2): ``_ssd_chunk_scan`` against ``ssd_reference`` on the card, on
    the inputs layer 0's mixer gives them on the path (recorded from a call
    of ``mamba2_apply`` on the embedded tokens), within TOL_SSD; both
    timed."""
    from repro_torch.models import mamba2 as mamba_lib
    from repro_torch.models.blocks import _norm
    cfg = model.cfg
    blk = params["blocks"][0]
    seen = []
    sound = mamba_lib._ssd_chunk_scan

    def grab(*a, **kw):
        seen.append((a, kw))
        return sound(*a, **kw)
    x = _norm(blk["ln"], model._embed_in(params, tokens), cfg)
    mamba_lib._ssd_chunk_scan = grab
    try:
        with torch.inference_mode():
            mamba_lib.mamba2_apply(blk["mixer"], x, cfg)
    finally:
        mamba_lib._ssd_chunk_scan = sound
    check(len(seen) == 1, f"layer 0's mixer called the chunk scan "
          f"{len(seen)} times")
    args, kw = seen[0]
    with torch.inference_mode():
        y1 = sound(*args, **kw)
        y2 = mamba_lib.ssd_reference(*args)
        ms1 = time_ms(lambda: sound(*args, **kw), 3)
        ms2 = time_ms(lambda: mamba_lib.ssd_reference(*args), 1)
    rel = max_err(y1, y2) / float(y2.abs().max())
    check(bool(torch.isfinite(y1).all()) and rel <= TOL_SSD,
          f"_ssd_chunk_scan vs ssd_reference: {rel}")
    log(f"{tag} _ssd_chunk_scan (chunk {kw['chunk']}) against ssd_reference "
        f"on layer 0's inputs, xh {tuple(args[0].shape)} (B, S, H, P), "
        f"state {args[3].shape[-1]}: max rel err {rel:.3e} (tol {TOL_SSD}); "
        f"{ms1:.3f} ms against the recurrence's {ms2:.1f} ms (plain PyTorch "
        f"both: the reference has no Pallas kernel here)")


def serve_f32_decode(model, params, tokens, tag):
    """(p2) in float32 compute (the same float32 params): decode of the
    first P_F32 positions against the prefill of those positions, within
    TOL_DECODE_F32."""
    from repro_torch.models.transformer import LMModel
    m32 = LMModel(dataclasses.replace(model.cfg, compute_dtype="float32"))
    x = tokens[:, :P_F32]
    with torch.inference_mode():
        full = m32._logits_fn(params)(m32.hidden_states(params, x)).float()
    cache = m32.init_cache(x.shape[0], P_F32, dtype=torch.float32,
                           device=x.device)
    dec, _ = _decode(m32, params, cache, x, 0, P_F32, range(P_F32))
    rel, frob, top1 = _vs_prefill(dec, full, float(full.abs().max()))
    check(rel <= TOL_DECODE_F32, f"{model.cfg.name} float32 decode vs "
          f"prefill: {rel}")
    log(f"{tag} float32 compute, {P_F32} positions from a float32 cache: "
        f"decode against prefill max rel err {rel:.3e}, Frobenius "
        f"{frob:.3e}, top-1 {top1:.4f} (tol {TOL_DECODE_F32})")


def serve_main_p(path):
    """Phase (p), run as ``chip_smoke.py --serve-phase-p PATH`` by
    :func:`serve_phase`: (p1) DeepSeek-V2 at 4 layers (MLA, B8 at D 192,
    Dv 128 on the tensor-core kernel, the SIMT kernel timed beside it),
    (p2) Mamba2-130m (no attention; the chunk scan against the recurrence)
    and (p3) Zamba2-2.7b (the shared block's B8 at D 80 on the
    tensor-core kernel, the SIMT kernel timed beside it) through
    ``serve_model``, each with its planted fault
    (``_p_faults``); writes the B8 rows as JSON to ``path``."""
    dev = _serve_setup("p")
    t_p = time.perf_counter()
    rows = []
    for name, (arch, layers, b, s_len, n_dec), tag, cfg_kw, kw in (
            ("deepseek", P_DEEPSEEK, "[p1]", {"capacity_factor": 8.0},
             dict(b8_route="wgmma", simt_too=True)),
            ("mamba2", P_MAMBA, "[p2]", {},
             dict(b8_count=0, tol=TOL_DECODE_SSM)),
            ("zamba2", P_ZAMBA, "[p3]", {},
             dict(b8_route="wgmma", simt_too=True, tol=TOL_DECODE_SSM,
                  tol_h=TOL_LATENTS_SSM))):
        if layers:
            cfg_kw["n_layers"] = layers
        cfg = _o_config(arch, **cfg_kw)
        if name == "zamba2":
            kw["b8_count"] = cfg.n_layers // cfg.shared_attn_every
        rows_m, model, params, tokens = serve_model(
            name, cfg, b, s_len, n_dec, list(range(n_dec)), tag, dev,
            faults=_p_faults, **kw)
        rows += rows_m
        if name == "mamba2":
            serve_ssd_check(model, params, tokens, tag)
            serve_f32_decode(model, params, tokens, tag)
        del model, params, tokens
        torch.cuda.empty_cache()
    log(f"[p] phase (p) took {time.perf_counter() - t_p:.1f}s in its process")
    with open(path, "w") as f:
        json.dump(rows, f)
    return 0


def _serve_setup(phase):
    """The child process of phase (o) or (p): the port on the path, exact
    float32 and bf16 products, the card named."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[{phase}] {torch.cuda.get_device_name(0)} ({card_line()}), a "
        f"process of its own")
    return torch.device("cuda")


def serve_main(path):
    """Phase (o), run as ``chip_smoke.py --serve-phase PATH`` by
    :func:`serve_phase`: (o1) Gemma2-2b and (o2) OLMoE-1B-7B through
    ``serve_model``, OLMoE's routed experts (``serve_moe_checks``), (o3)
    A7's examples; writes the B8 rows as JSON to ``path``."""
    dev = _serve_setup("o")
    t_o = time.perf_counter()
    arch, b, s_len, n_dec = O_GEMMA
    rows, model, params, tokens = serve_model(
        "gemma2", _o_config(arch, n_layers=O_GEMMA_LAYERS), b, s_len, n_dec,
        list(range(O_FIRST)) + list(range(n_dec - O_LAST, n_dec)), "[o1]",
        dev, faults=_planted_faults)
    del model, params, tokens
    torch.cuda.empty_cache()
    arch, b, s_len, n_dec = O_OLMOE
    rows_m, model, params, tokens = serve_model(
        "olmoe", _o_config(arch, capacity_factor=8.0), b, s_len, n_dec,
        list(range(n_dec)), "[o2]", dev)
    rows += rows_m
    serve_moe_checks(model, params, tokens, "[o2]")
    del model, params, tokens
    torch.cuda.empty_cache()
    serve_examples(dev)
    log(f"[o] phase (o) took {time.perf_counter() - t_o:.1f}s in its process")
    with open(path, "w") as f:
        json.dump(rows, f)
    return 0


def train_q1(dev):
    """(q1) B8's backward kernel alone at each shape of ``BWD_CASES``: the
    forward through B8, then ``launch_bwd`` against
    ``flash_attention_bwd_ref`` on the same inputs (TOL_ATTN_BWD_F32), a
    second launch bit-identical, its time (the three kernels together,
    CUDA events) beside the bound (the backward's products: the scores,
    dP, dV, dQ and dK once each), the plain backward's and, without
    softcap or window, the backward alone of SDPA.  Returns the rows of the
    ``kernels`` line by name (launches 0: phases (q2) and (q3) fill in
    those of their paths)."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    gen = torch.Generator(device=dev).manual_seed(31)
    rows = {}
    for name, b, s_len, hq, hkv, d, dv, dt, cap, win, reps in BWD_CASES:
        q, k, v = (torch.randn((b, s_len, h, w), generator=gen,
                               device=dev).to(dt)
                   for h, w in ((hq, d), (hkv, d), (hkv, dv)))
        dout = torch.randn((b, s_len, hq, dv), generator=gen,
                           device=dev).to(dt)
        out = torch.empty_like(dout)
        scale = d ** -0.5
        tq, tk, tv, to, tdo = (t_.transpose(1, 2)
                               for t_ in (q, k, v, out, dout))
        flash_ops.launch(tq, tk, tv, to, scale=scale, softcap=cap,
                         window=win)
        kw = dict(scale=scale, softcap=cap, window=win)
        kernels.reset_launches()
        got = flash_ops.launch_bwd(tq, tk, tv, to, tdo, **kw)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["flash_attention_bwd"] == 1
              and sum(kernels.LAUNCHES.values()) == 1,
              f"{name}: launches {kernels.LAUNCHES}")
        want = flash_attention_bwd_ref(tq, tk, tv, to, tdo, **kw)
        errs = [attn_close(g_, w_, f"{name} d{x}", TOL_ATTN_BWD_F32)
                for g_, w_, x in zip(got, want, "qkv")]
        again = flash_ops.launch_bwd(tq, tk, tv, to, tdo, **kw)
        check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
              f"{name}: a second launch differs")
        scale_w = [float(w_.float().abs().max()) for w_ in want]
        del want, again
        torch.cuda.empty_cache()
        ms = time_ms(lambda: flash_ops.launch_bwd(tq, tk, tv, to, tdo, **kw),
                     reps)
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(
            tq, tk, tv, to, tdo, **kw), 1)
        torch.cuda.empty_cache()
        lib_ms = None
        if not cap and not win:
            leaves = [t_.detach().clone().requires_grad_() for t_ in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(
                *[t_.transpose(1, 2) for t_ in leaves], is_causal=True,
                enable_gqa=True, scale=scale)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                o_lib, leaves, tdo, retain_graph=True), reps)
            del o_lib, leaves
        # the products a backward needs: the scores once (D), dP = dO V^T
        # and dV = P^T dO (Dv each), dQ = dS K and dK = dS^T Q (D each);
        # float32-accurate products as three TF32 ones, as B8's rows
        flops = 2.0 * attn_pairs(s_len, win) * (3 * d + 2 * dv) * b * hq
        if dt == torch.bfloat16:
            b_ms, b_by = bound(nbytes(q, k, v, out, dout) + nbytes(*got),
                               flops, BF16_FLOPS_PER_S)
        else:
            b_ms, b_by = bound(nbytes(q, k, v, out, dout) + nbytes(*got),
                               3.0 * flops, TF32_FLOPS_PER_S)
        err = max(errs)
        rows[name] = {"name": name, "route": "cuda",
                      "source": B8_BWD_SOURCE, "replaces": B8_BWD_REPLACES,
                      "launches": 0, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms}
        log(f"[q1] {name}: B {b}, S {s_len}, Hq {hq}, Hkv {hkv}, D {d}, Dv "
            f"{dv}, {str(dt)[6:]}, softcap {cap}, window {win}, (B, S, H, "
            f"D) strides: {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s, "
            f"{b_ms / ms:.2%} of the bound), bound {b_ms:.4f} ms by {b_by}, "
            f"plain {plain_ms:.3f} ms"
            + ("" if lib_ms is None else f", SDPA backward {lib_ms:.4f} ms")
            + f"; max abs err dq / dk / dv {errs[0]:.3e} / {errs[1]:.3e} / "
            f"{errs[2]:.3e} (largest |entry| {scale_w[0]:.3e} / "
            f"{scale_w[1]:.3e} / {scale_w[2]:.3e}); a second launch "
            "bit-identical")
        del q, k, v, out, dout, got, tq, tk, tv, to, tdo
        torch.cuda.empty_cache()
    return rows


def _named_leaves(tree, path=""):
    """[(path, tensor)] of a tree of dicts and lists, in ``tree_leaves``'s
    order."""
    if isinstance(tree, dict):
        return [x for k_, v_ in tree.items()
                for x in _named_leaves(v_, f"{path}.{k_}" if path else k_)]
    if isinstance(tree, (list, tuple)):
        return [x for i_, v_ in enumerate(tree)
                for x in _named_leaves(v_, f"{path}[{i_}]")]
    return [(path, tree)]


class _SwapKV(torch.autograd.Function):
    """Identity on (k, v) whose backward hands k's gradient to v and v's to
    k: put in front of B8, it plants B8-bwd returning dK and dV swapped."""

    @staticmethod
    def forward(ctx, k, v):
        return k.clone(), v.clone()

    @staticmethod
    def backward(ctx, gk, gv):
        return gv, gk


def train_q2_grads(cfg, batch, seq, dev):
    """(q2) gradients through attention on the training path: every
    parameter's gradient of train_lm's first loss (``init_params(0)``, the
    first batch) through B8 and its backward kernel against the same
    model's with the plain attention (``flash_chunked_ref``) under
    autograd, each leaf within TOL_TRAIN_GRAD of its largest |entry|; B8
    and B8-bwd once a layer; two planted faults read above the bound."""
    from repro_torch import kernels
    from repro_torch.launch.train import make_data_fn
    from repro_torch.models.attention import flash_chunked, flash_chunked_ref
    from repro_torch.models.transformer import LMModel
    params = LMModel(cfg).init_params(0, device=dev)
    data = make_data_fn(cfg, batch, seq, dev)(0)
    named = _named_leaves(params)
    for _, t_ in named:
        t_.requires_grad_(True)

    def grads(attention):
        loss, _ = LMModel(cfg, attention=attention).loss_and_aux(
            params, data["inputs"], data["labels"])
        return torch.autograd.grad(loss, [t_ for _, t_ in named],
                                   allow_unused=True, materialize_grads=True)

    def swapped(q, k, v, **kw):
        return flash_chunked(q, *_SwapKV.apply(k, v), **kw)

    def cut(q, k, v, **kw):
        return flash_chunked(q, k, v, **kw).detach()

    want = grads(flash_chunked_ref)

    def worst(got):
        out = (0.0, "")
        for (n_, _), g_, w_ in zip(named, got, want):
            e_ = float((g_ - w_).abs().max())
            top = float(w_.abs().max())
            out = max(out, (e_ / top if top > 0 else e_, n_))
        return out

    kernels.reset_launches()
    sound = worst(grads(flash_chunked))
    la = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
    faults = {"dK and dV swapped": worst(grads(swapped)),
              "attention's gradient cut": worst(grads(cut))}
    log(f"[q2] gradients of the first loss ({len(named)} leaves) through B8 "
        f"and B8-bwd against the plain attention's under autograd: worst "
        f"leaf {sound[1]} {sound[0]:.3e} of its largest |entry| "
        f"(TOL_TRAIN_GRAD {TOL_TRAIN_GRAD:g}); launches {la}; planted "
        "faults: " + "; ".join(f"{k_} {e_:.3e} at {n_}"
                               for k_, (e_, n_) in faults.items()))
    check(sound[0] <= TOL_TRAIN_GRAD,
          f"[q2] gradients: {sound[0]:.3e} at {sound[1]}")
    check(sum(la.values()) == 2 * cfg.n_layers
          and la.get("flash_attention_bwd") == cfg.n_layers,
          f"[q2] gradients: launches {la}")
    for name, (e_, n_) in faults.items():
        check(e_ > TOL_TRAIN_GRAD,
              f"[q2] planted fault ({name}) read {e_:.3e} at {n_}, within "
              f"TOL_TRAIN_GRAD")
    del params, data, want
    torch.cuda.empty_cache()


def train_q2(dev):
    """(q2) ``repro_torch.examples.train_lm`` on the card: the 300-step run
    with its loss falling, then ``--fail-at Q_FAIL_AT`` into a fresh
    directory and the rerun, which resumes at Q_RESUME_AT and whose losses
    equal the uninterrupted run's bit for bit; each run's launches (B8's
    forward on the kernel ``kernel_route`` names and its backward, once a
    layer a step, nothing else).  Returns the uninterrupted run's B8-bwd
    launches."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.configs.base import get_arch
    from repro_torch.examples import train_lm
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.train import reduced_variant
    from repro_torch.runtime.trainer import SimulatedFailure
    cfg = reduced_variant(get_arch("qwen2-7b"))
    steps_ = int(train_lm.ARGS[train_lm.ARGS.index("--steps") + 1])
    batch = int(train_lm.ARGS[train_lm.ARGS.index("--batch") + 1])
    seq = int(train_lm.ARGS[train_lm.ARGS.index("--seq") + 1])
    route = flash_ops.kernel_route(getattr(torch, cfg.compute_dtype),
                                   cfg.resolved_head_dim)
    fwd_key = f"flash_attention_{route}"
    train_q2_grads(cfg, batch, seq, dev)

    def launches_ok(la, n_steps, label):
        want = {fwd_key: cfg.n_layers * n_steps,
                "flash_attention_bwd": cfg.n_layers * n_steps}
        got = {k_: v_ for k_, v_ in la.items() if v_}
        check(got == want, f"{label}: launches {got}, expected {want}")
        return got

    with tempfile.TemporaryDirectory() as d:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = train_lm.main(["--ckpt-dir", os.path.join(d, "a")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        la = launches_ok(kernels.LAUNCHES, steps_, "[q2] train_lm")
        losses = [h_["loss"] for h_ in hist]
        first = sum(losses[:Q_WINDOW]) / Q_WINDOW
        last = sum(losses[-Q_WINDOW:]) / Q_WINDOW
        check(len(hist) == steps_ and all(math.isfinite(x) for x in losses)
              and last < first, f"[q2] losses: first {first}, last {last}")
        ms = sorted(h_["sec"] for h_ in hist[1:])
        ms_step = 1e3 * ms[len(ms) // 2]
        log(f"[q2] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
            f"{cfg.compute_dtype}): {steps_} steps at B {batch} x {seq} in "
            f"{wall:.1f}s; mean loss of the first {Q_WINDOW} steps "
            f"{first:.4f}, of the last {Q_WINDOW} {last:.4f} (step 0 "
            f"{losses[0]:.4f}, step {steps_ - 1} {losses[-1]:.4f}); median "
            f"{ms_step:.2f} ms a step, {batch * seq / ms_step * 1e3:.0f} "
            f"tokens/s (the first step {1e3 * hist[0]['sec']:.0f} ms); "
            f"launches {la} (B8 forward on the {B8_LABEL[route]} kernel)")

        kernels.reset_launches()
        crash = os.path.join(d, "b")
        try:
            train_lm.main(["--ckpt-dir", crash, "--fail-at", str(Q_FAIL_AT)])
            check(False, f"[q2] --fail-at {Q_FAIL_AT} did not fail")
        except SimulatedFailure:
            pass
        launches_ok(kernels.LAUNCHES, Q_FAIL_AT, "[q2] --fail-at run")
        kernels.reset_launches()
        t0 = time.perf_counter()
        resumed = train_lm.main(["--ckpt-dir", crash])
        wall_r = time.perf_counter() - t0
        start = resumed[0]["step"]
        launches_ok(kernels.LAUNCHES, steps_ - start, "[q2] rerun")
        # a straggler alarm between Q_RESUME_AT and Q_FAIL_AT snapshots a
        # later boundary, which the rerun then restores
        check(Q_RESUME_AT <= start <= Q_FAIL_AT
              and [h_["step"] for h_ in resumed] == list(range(start, steps_)),
              f"[q2] the rerun ran steps {start}..{resumed[-1]['step']}")
        ref = {h_["step"]: h_["loss"] for h_ in hist}
        diff = [h_["step"] for h_ in resumed if h_["loss"] != ref[h_["step"]]]
        check(not diff, f"[q2] the resumed losses differ at steps {diff[:8]}")
        log(f"[q2] --fail-at {Q_FAIL_AT}: failed before step {Q_FAIL_AT}; "
            f"the rerun restored step {start} (the periodic checkpoint: "
            f"{Q_RESUME_AT}) and ran steps {start}-{steps_ - 1} in "
            f"{wall_r:.1f}s, every loss bit for bit the uninterrupted run's "
            f"({len(resumed)} steps)")
    return la.get("flash_attention_bwd", 0)


def _attention_off(q, k, v, **kw):
    """A planted fault: attention's output zeroed, (B, S, Hq, Dv)."""
    return q.new_zeros((*q.shape[:-1], v.shape[-1]))


def train_q3(dev):
    """(q3) MusicGen-large at full width and depth: Q3_STEPS AdamW steps
    (``make_train_step``, remat "nothing") on one batch with the launch
    counters at 0 just before: every loss finite, the last below the
    first, the first within TOL_TRAIN_LOSS of the plain attention's loss
    on the same weights and the plain loss with attention's output
    zeroed (a planted fault) outside it; B8's forward twice a layer a step
    (once more under remat) on the tensor-core kernel, its backward once;
    the peak memory, ms a step, tokens/s.  Returns the B8-bwd launches."""
    from repro_torch import kernels
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.launch.train import make_data_fn
    from repro_torch.models.attention import flash_chunked_ref
    from repro_torch.models.transformer import LMModel
    from repro_torch.optim.optimizers import tree_leaves
    cfg = _o_config("musicgen-large")
    b, s_len = Q3_SHAPE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LMModel(cfg)
    params = model.init_params(0, device=dev)
    n_par = sum(t_.numel() for t_ in tree_leaves(params))
    batch = make_data_fn(cfg, b, s_len, dev)(0)
    with torch.no_grad():
        ref_loss, _ = LMModel(cfg, attention=flash_chunked_ref).loss_and_aux(
            params, batch["inputs"], batch["labels"])
        # the planted fault: attention's output zeroed in every layer
        off_loss, _ = LMModel(cfg, attention=_attention_off).loss_and_aux(
            params, batch["inputs"], batch["labels"])
    ref_loss = float(ref_loss)
    off_rel = abs(float(off_loss) - ref_loss) / abs(ref_loss)
    opt = make_optimizer(cfg, peak_lr=Q3_LR, warmup=0, total=Q3_STEPS)
    step_fn = make_train_step(model, opt)
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    t_set = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, times = [], []
    for _ in range(Q3_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    la = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
    want = {"flash_attention_wgmma": 2 * cfg.n_layers * Q3_STEPS,
            "flash_attention_bwd": cfg.n_layers * Q3_STEPS}
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms_step = 1e3 * sum(times[1:]) / (len(times) - 1)
    log(f"[q3] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {n_par / 1e9:.3f} B {cfg.param_dtype} "
        f"params, {cfg.compute_dtype} compute, remat {cfg.remat_policy!r}, "
        f"AdamW {cfg.opt_state_dtype} moments at lr {Q3_LR} with no "
        f"warm-up; set-up (threefry init, the plain attention's loss) "
        f"{t_set:.1f}s; {Q3_STEPS} steps on one batch of B {b} x S {s_len}: "
        "losses " + ", ".join(f"{x:.5f}" for x in losses)
        + f"; the plain attention's first loss {ref_loss:.5f} ({rel:.3e} "
        f"relative; TOL_TRAIN_LOSS {TOL_TRAIN_LOSS:g}; with attention's "
        f"output zeroed {float(off_loss):.5f}, {off_rel:.3e}); "
        f"{ms_step:.1f} ms a step after the first ({1e3 * times[0]:.1f} "
        f"ms), {b * s_len / ms_step * 1e3:.0f} tokens/s; peak memory "
        f"{peak:.1f} GB; launches {la}")
    check(la == want, f"[q3] launches {la}, expected {want}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and rel <= TOL_TRAIN_LOSS,
          f"[q3] losses {losses}, plain {ref_loss} ({rel:.3e})")
    check(off_rel > TOL_TRAIN_LOSS,
          f"[q3] the planted fault (attention off) read {off_rel:.3e}, "
          "within TOL_TRAIN_LOSS")
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return la.get("flash_attention_bwd", 0)


def train_main_q(path):
    """Phase (q), run as ``chip_smoke.py --train-phase-q PATH`` by
    :func:`serve_phase`: (q1) B8's backward kernel at each shape, (q2)
    ``train_lm`` with its restart, (q3) MusicGen-large; writes the B8-bwd
    rows as JSON to ``path``."""
    dev = _serve_setup("q")
    t_q = time.perf_counter()
    rows = train_q1(dev)
    rows["flash_attention_bwd_train_lm"]["launches"] = train_q2(dev)
    rows["flash_attention_bwd_musicgen"]["launches"] = train_q3(dev)
    log(f"[q] phase (q) took {time.perf_counter() - t_q:.1f}s in its process")
    with open(path, "w") as f:
        json.dump(list(rows.values()), f)
    return 0


SERVE_PHASES = {"o": ("--serve-phase", O_TIMEOUT),
                "p": ("--serve-phase-p", P_TIMEOUT),
                "q": ("--train-phase-q", Q_TIMEOUT)}


def serve_phase(phase):
    """Phase (o), (p) or (q) in a child process (see ``serve_main``,
    ``serve_main_p`` and ``train_main_q``); returns its rows of the
    ``kernels`` line."""
    import tempfile
    flag, timeout = SERVE_PHASES[phase]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rows.json")
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              flag, path], timeout=timeout)
        check(res.returncode == 0,
              f"phase ({phase}) exited with {res.returncode}")
        with open(path) as f:
            rows = json.load(f)
    log(f"[{phase}] phase ({phase}) took {time.perf_counter() - t0:.1f}s with "
        f"its process's start")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-phase":
        return serve_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-phase-p":
        return serve_main_p(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--train-phase-q":
        return train_main_q(sys.argv[2])
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import kernels
    from repro_torch.core import (baselines, funcsne, hierarchy, knn,
                                  ld_kernels, nnd, threefry)
    from repro_torch.core import dbscan as dbscan_mod
    from repro_torch.core.quality import embedding_quality
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.knn_merge.ops import knn_merge, knn_merge_cand
    from repro_torch.kernels.knn_merge.ref import (knn_merge_cand_ref,
                                                   knn_merge_ref)
    from repro_torch.kernels.ne_forces import ops as force_ops
    from repro_torch.kernels.ne_forces.ops import (edges_route, ne_forces,
                                                   ne_forces_gather,
                                                   ne_forces_scatter)
    from repro_torch.kernels.ne_forces.ref import (ne_forces_gather_ref,
                                                   ne_forces_ref,
                                                   ne_forces_scatter_ref)
    from repro_torch.kernels.pairwise_sqdist.ops import (
        gather_route, pairwise_sqdist, pairwise_sqdist_gather)
    from repro_torch.kernels.pairwise_sqdist.ref import (
        pairwise_sqdist_gather_ref, pairwise_sqdist_ref)
    from repro_torch.kernels.segment_sum import ops as seg_ops
    from repro_torch.kernels.segment_sum.ops import segment_sum
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.knn_merge.ops import MAX_C, MAX_K, merge_route
    from repro_torch.configs.base import get_arch, smoke_variant
    from repro_torch.examples import embed_latents
    from repro_torch.models.attention import flash_chunked, flash_chunked_ref
    from repro_torch.models.transformer import LMModel
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 matmuls accumulate in fp32 throughout, as XLA's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    def gather_key(m, aligned=True):
        """The launch counter of B1 on rows of m floats: the lane or ring
        route's, or the warp route's."""
        route = gather_route(m, aligned)
        return "pairwise_sqdist_gather" + ("" if route == "warp"
                                           else f"_{route}")

    def edges_key(op, d):
        """The launch counter of B5 ("ne_forces_gather") or B7
        ("ne_forces") at width d: the rounds or staged route's, or the warp
        route's."""
        route = edges_route(d)
        return op if route == "warp" else f"{op}_{route}"
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

    X_np, y_np = synthetic.mnist_like(n=N, dim=DIM, seed=0)
    X = torch.from_numpy(X_np).to(dev)
    Xq = torch.round(X)            # integer features: exact distances
    cfg = funcsne.FuncSNEConfig(n_points=N, dim_hd=DIM)
    hp = funcsne.default_hparams(N, device=dev)
    log(f"    X {tuple(X.shape)} {X.numel() * 4 / 1e6:.1f} MB on the card")

    # ---- (b) each kernel against its plain version ----------------------
    log(f"[b] starts {time.perf_counter() - t_start:.1f}s into the script")
    # one step on quantised data through recording ops gives every kernel's
    # main-path inputs (the gate always fires at step 0: E[N_new/N] = 1)
    rec = Recorder(funcsne)
    stq = funcsne.init_state(Xq, cfg, seed=1, device=dev, ops=rec.ops)
    y_real = stq.Y
    stq = stq._replace(Y=torch.round(stq.Y * 400.0) / 4.0)  # quarter grid
    funcsne.funcsne_step(cfg, stq, Xq, hp, ops=rec.ops)
    check(set(rec.calls) == {"pairwise_sqdist_gather_hd",
                             "pairwise_sqdist_gather_ld",
                             "knn_merge_cand_hd", "knn_merge_cand_ld",
                             "ne_forces_scatter"}, f"calls {set(rec.calls)}")
    errs = {}

    # B1 on each of its routes: lanes at d = 2 (init_state's C 16, and C 24
    # as merge_fused=False's LD call scores the list and the candidates),
    # ring at 784 (init_state's C 32, merge_fused=False's HD C 10), warp at
    # 783 and 16 columns; exact on the integer grids, within TOL_SQDIST_REL
    # on the real X and Y
    _, (_, qid, cand_hd), _ = rec.calls["pairwise_sqdist_gather_hd"]
    _, (_, _, cand_ld), _ = rec.calls["pairwise_sqdist_gather_ld"]
    cand_24 = torch.cat([cand_ld, cand_hd[:, :8]], dim=1).contiguous()
    cand_10 = cand_hd[:, :10].contiguous()
    for route, xq_, xr_, cand_ in (
            ("lanes", stq.Y, y_real, cand_ld),
            ("lanes", stq.Y, y_real, cand_24),
            ("ring", Xq, X, cand_hd), ("ring", Xq, X, cand_10),
            ("warp", Xq[:, :783].contiguous(), X[:, :783].contiguous(),
             cand_hd),
            ("warp", Xq[:, :16].contiguous(), X[:, :16].contiguous(),
             cand_hd)):
        key = gather_key(xq_.shape[1])
        label = f"B1 {route} M={xq_.shape[1]} C={cand_.shape[1]}"
        check(gather_route(xq_.shape[1]) == route, f"{label}: route {key}")
        kernels.reset_launches()
        got = pairwise_sqdist_gather(xq_, qid, cand_)
        check(kernels.LAUNCHES[key] == 1
              and sum(kernels.LAUNCHES.values()) == 1,
              f"{label}: launches {kernels.LAUNCHES}")
        check(torch.equal(got, pairwise_sqdist_gather_ref(xq_, qid, cand_)),
              f"{label} not exact on quantised inputs")
        got = pairwise_sqdist_gather(xr_, qid, cand_)
        want = pairwise_sqdist_gather_ref(xr_, qid, cand_)
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        check(rel <= TOL_SQDIST_REL, f"{label}: real-input relative error "
              f"{rel}")
        log(f"[b] {label} ({key}): exact on quantised inputs; on the real "
            f"{'Y' if xq_ is stq.Y else 'X'} max abs err "
            f"{max_err(got, want):.3e}, max rel {rel:.3e} "
            f"(tol {TOL_SQDIST_REL})")
    del got, want, cand_24, cand_10, y_real

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
    log(f"[c] starts {time.perf_counter() - t_start:.1f}s into the script")
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
    log(f"[d] starts {time.perf_counter() - t_start:.1f}s into the script")
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
    def merge_key(op, m, mode, k, c):
        """The launch counter of B2 ("knn_merge_cand") or B4 ("knn_merge")
        on rows of m floats: the lane or ring route's, or the warp route's
        by mode."""
        route = merge_route(m, k, c)
        return f"{op}_{mode}" if route == "warp" else f"{op}_{route}"

    def c_hd_of(c_):
        return c_.c_hd_non + c_.c_hd_ld + c_.c_hd_ld_non + c_.c_hd_rand \
            + c_.c_hd_rev
    c_ld = cfg.c_ld_non + cfg.c_ld_hd + cfg.c_ld_rand
    ld_key = {op: merge_key(op, cfg.dim_ld, "ld", cfg.k_ld, c_ld)
              for op in ("knn_merge_cand", "knn_merge")}
    # the HD refinement at MNIST's width: the ring route
    hd_key = {op: merge_key(op, DIM, "hd", cfg.k_hd, c_hd_of(cfg))
              for op in ("knn_merge_cand", "knn_merge")}
    check(set(hd_key.values()) == {"knn_merge_cand_ring", "knn_merge_ring"},
          f"HD merges at {DIM} columns route to {hd_key}")
    # init_state's B1 calls: the ring at MNIST's width, the lanes at d = 2
    b1_key = {"hd": gather_key(DIM), "ld": gather_key(cfg.dim_ld)}
    check(b1_key == {"hd": "pairwise_sqdist_gather_ring",
                     "ld": "pairwise_sqdist_gather_lanes"},
          f"B1 at {DIM} and {cfg.dim_ld} columns routes to {b1_key}")
    main_kernels = {*b1_key.values(), hd_key["knn_merge_cand"],
                    ld_key["knn_merge_cand"], "ne_forces_scatter"}
    for name, cnt in launches.items():
        check((cnt > 0) == (name in main_kernels),
              f"kernel {name}: {cnt} launches on the main path")
    check(all(launches[k_] == 1 for k_ in b1_key.values()),
          f"B1 launched {[launches[k_] for k_ in b1_key.values()]} times, "
          "once a call of init_state expected")
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
    log(f"[e] starts {time.perf_counter() - t_start:.1f}s into the script")
    out = []

    def kernel_split(fn, reps=20):
        """Device ms per call of each kernel and memset that ``fn`` runs,
        by name, from a profiler trace of ``reps`` calls, and how many
        events the trace holds of each (a kernel of one launch a call:
        ``reps``, unless the trace lost some).  A trace that lost every
        device event is taken once more."""
        fn()
        torch.cuda.synchronize()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            evs = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0]
            if evs:
                break
            log("    the profiler's trace holds no device event: "
                "taken again")
        check(evs, "the profiler saw no kernel")
        return ({ev.key: ev.self_device_time_total / 1e3 / reps for ev in evs},
                {ev.key: ev.count for ev in evs})

    def entry(name, source, replaces, fn, plain, reps, bytes_, flops, err,
              count, library=None, tag="[e]", peak=None, graphed=False):
        """One kernel row: its time issued from the host (CUDA events), the
        plain version's and the library call's; with ``graphed`` also its
        time from CUDA graphs and a profiler split by kernel name."""
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
        g_ms = None
        if graphed:
            g_ms = graph_ms(fn, reps)
            by_kernel, events = kernel_split(fn)
            log(f"    {name}: {g_ms:.4f} ms from CUDA graphs "
                f"({b_ms / g_ms:.1%} of the bound); device ms per call by "
                "kernel (profiler, 20 calls; events in the trace): "
                + "; ".join(f"{k_[:60]} {v_:.4f} ({events[k_]})" for k_, v_ in
                            sorted(by_kernel.items(), key=lambda kv: -kv[1]))
                + f"; sum {sum(by_kernel.values()):.4f}")
        return g_ms

    def b1_entry(case, x, qid, cand, count, tag):
        """B1's row at one of the shapes its paths give it, on the real
        inputs: held against the plain version (TOL_SQDIST_REL), timed
        beside its bound (x, the ids and the output moved once; 3 flops a
        column of every slot, all of which it scores), from CUDA graphs
        too; the rows it scores, the bytes it gathers ((1 + C) rows of M
        floats a query, the ids and the output) and their rate from CUDA
        graphs.  ``count``: its launches over the path that runs it."""
        key = gather_key(x.shape[1], x.data_ptr() % 16 == 0)
        got = pairwise_sqdist_gather(x, qid, cand)
        want = pairwise_sqdist_gather_ref(x, qid, cand)
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        check(rel <= TOL_SQDIST_REL, f"B1 {case}: relative error {rel}")
        (b, c), m = cand.shape, x.shape[1]
        g_ms = entry(f"{key}_{case}", "src/repro_torch/csrc/pairwise_sqdist.cu",
                     "src/repro/kernels/pairwise_sqdist/kernel.py:278",
                     lambda: pairwise_sqdist_gather(x, qid, cand),
                     lambda: pairwise_sqdist_gather_ref(x, qid, cand), 20,
                     nbytes(x, qid, cand, got), 3.0 * b * c * m,
                     max_err(got, want), count, tag=tag, graphed=True)
        gb = (b * (1 + c) * m * 4 + nbytes(qid, cand, got)) / 1e9
        log(f"    {key}_{case}: x {tuple(x.shape)}"
            + ("" if x.data_ptr() % 16 == 0 else " (not on 16 bytes)")
            + f" C={c}, {b * c} rows scored, {gb:.4f} GB gathered, "
            f"{gb / g_ms:.2f} TB/s from CUDA graphs; max rel err {rel:.3e}")

    # the final main-path state gives the timed inputs; B1 at init_state's
    # shapes: random lists of k_hd on X and of k_ld on Y
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    cand = knn.init_knn_idx(threefry.prng_key(3), N, N, cfg.k_hd, device=dev)
    b1_entry("init_hd", X, ids, cand, launches[b1_key["hd"]], "[e]")
    cand = knn.init_knn_idx(threefry.prng_key(4), N, N, cfg.k_ld, device=dev)
    b1_entry("init_ld", st.Y, ids, cand, launches[b1_key["ld"]], "[e]")
    del cand

    def b2_entry(name, call, err, count, tag, graphed=False):
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
              3.0 * scored * x.shape[1], err, count, tag=tag,
              graphed=graphed)
        log(f"    {name}: x {tuple(x.shape)} K={cur_idx.shape[1]} C="
            f"{c_cand.shape[1]}, {scored} rows scored "
            f"({valid.float().mean():.3f} of candidates new)")

    rec = Recorder(funcsne)
    base = knn.key_salt(st.rng)
    st_t = funcsne._hd_refine(cfg, st, X, base, rec.ops)
    funcsne._ld_refine(cfg, st_t, base, rec.ops)
    funcsne._forces_update(cfg, st_t, hp, base, rec.ops)
    for mode in ("hd", "ld"):
        b2_entry(hd_key["knn_merge_cand"] if mode == "hd"
                 else f"knn_merge_cand_{mode}",
                 rec.calls[f"knn_merge_cand_{mode}"],
                 errs[f"knn_merge_cand_{mode}"],
                 launches[ld_key["knn_merge_cand"] if mode == "ld"
                          else hd_key["knn_merge_cand"]], "[e]",
                 graphed=True)

    _, (y, qid, nbr, coef, alpha), kw = rec.calls["ne_forces_scatter"]
    scats, wsums = ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw)
    entry("ne_forces_scatter", "src/repro_torch/csrc/ne_forces.cu",
          "src/repro/kernels/ne_forces/kernel.py:451",
          lambda: ne_forces_scatter(y, qid, nbr, coef, alpha, **kw),
          lambda: ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw), 50,
          nbytes(y, qid, nbr, coef, alpha, *scats, *wsums),
          20.0 * nbr.numel(), errs["ne_forces_scatter"],
          launches["ne_forces_scatter"], graphed=True)

    # (m2) the kernels at the distributed step's slices (phase (m)), held
    # and timed here, where the profiler splits a call by kernel; recorded
    # from phase (d)'s final state through a ``RankView``: rank 1 of (2, 1)
    # scores rows 35,000-69,999 on all of X, rank 1 of (1, 2) every row on
    # its column block X[:, 392:], and rank 2 of (2, 2) rows 35,000-69,999
    # on X[:, :392] (held only: no run of (m3) has that grid).  Each row
    # takes its launches from the (m3) run of its shape: (row, run, counter)
    half = N // 2

    def slice_calls(shape, coords, state, x):
        ctx = funcsne.AxisCtx(points=("data",), feat="model",
                              grid=RankView(shape, coords))
        rec_ = Recorder(funcsne)
        base_ = knn.key_salt(state.rng)
        funcsne._hd_refine(cfg, state, x, base_, rec_.ops, ctx=ctx)
        funcsne._ld_refine(cfg, state, base_, rec_.ops, ctx)
        funcsne._forces_update(cfg, state, hp, base_, rec_.ops, ctx)
        return rec_.calls
    calls21 = slice_calls((2, 1), (1, 0), st, X)
    check(set(calls21) == {"pairwise_sqdist_gather_hd", "knn_merge_cand_ld",
                           "ne_forces_scatter"},
          f"a grid rank's step called {set(calls21)}")
    m_rows = []
    for label, cols, shape, coords, start, run in (
            ("slice784", slice(None), (2, 1), (1, 0), half, "(2,1) run 1"),
            ("cols392", slice(392, None), (1, 2), (0, 1), 0, "(1,2)"),
            ("slice392", slice(None, 392), (2, 2), (1, 0), half, None)):
        xr_, xq_ = X[:, cols].contiguous(), Xq[:, cols].contiguous()
        calls_ = (calls21 if shape == (2, 1)
                  else slice_calls(shape, coords, st, xr_))
        _, (_, qid, cand), _ = calls_["pairwise_sqdist_gather_hd"]
        check(qid.shape[0] == N - start and int(qid[0]) == start
              and int(qid[-1]) == N - 1, f"B1 {label}: rows {qid.shape}")
        key = gather_key(xq_.shape[1])
        check(key == b1_key["hd"], f"B1 at {xq_.shape[1]} columns: {key}")
        kernels.reset_launches()
        got = pairwise_sqdist_gather(xq_, qid, cand)
        check(kernels.LAUNCHES[key] == 1
              and sum(kernels.LAUNCHES.values()) == 1,
              f"B1 {label}: launches {kernels.LAUNCHES}")
        check(torch.equal(got, pairwise_sqdist_gather_ref(xq_, qid, cand)),
              f"B1 {label} not exact on quantised inputs")
        log(f"[m2] B1 {label} (rank {coords} of {shape}): x "
            f"{tuple(xr_.shape)}, rows {start}-{N - 1}, C={cand.shape[1]} "
            f"({key}): exact on quantised inputs")
        if run is None:
            got = pairwise_sqdist_gather(xr_, qid, cand)
            want = pairwise_sqdist_gather_ref(xr_, qid, cand)
            rel = float(((got - want).abs()
                         / want.abs().clamp_min(1.0)).max())
            check(rel <= TOL_SQDIST_REL, f"B1 {label}: relative error {rel}")
            log(f"    real max rel err {rel:.3e} (tol {TOL_SQDIST_REL})")
        else:
            # held on the real inputs (TOL_SQDIST_REL) and timed
            b1_entry(label, xr_, qid, cand, None, "[m2]")
            m_rows.append((out[-1], run, b1_key["hd"]))
        del calls_, got, xr_, xq_
    # the LD merge on Y on a quarter grid (|y| <= 64): distances exact
    yq = torch.round(st.Y * (256.0 / float(st.Y.abs().max()))) / 4.0
    calls21q = slice_calls((2, 1), (1, 0), st._replace(Y=yq), X)
    _, args_q, kw_q = calls21q["knn_merge_cand_ld"]
    check(args_q[1].shape[0] == half and int(args_q[1][0]) == half,
          "B2 LD: not the row slice")
    kernels.reset_launches()
    got = knn_merge_cand(*args_q, **kw_q)
    check(kernels.LAUNCHES[ld_key["knn_merge_cand"]] == 1
          and sum(kernels.LAUNCHES.values()) == 1,
          f"B2 LD slice: launches {kernels.LAUNCHES}")
    want = knn_merge_cand_ref(*args_q, **kw_q)
    for g, w, name in zip(got, want, ("idx", "d", "improved")):
        check(torch.equal(g, w), f"B2 LD slice {name} differs")
    _, args_r, kw_r = calls21["knn_merge_cand_ld"]
    got = knn_merge_cand(*args_r, **kw_r)
    want = knn_merge_cand_ref(*args_r, **kw_r)
    fin = torch.isfinite(want[1])
    err_b2 = max_err(got[1][fin], want[1][fin])
    log(f"[m2] B2 LD rescore, rows {half}-{N - 1}: idx/d/improved exact on "
        f"a quarter grid of Y; on the real Y max abs err of d {err_b2:.3e}, "
        f"ids equal on {float((got[0] == want[0]).float().mean()):.6f} of "
        "slots")
    b2_entry(f"{ld_key['knn_merge_cand']}_slice", calls21["knn_merge_cand_ld"],
             err_b2, None, "[m2]", graphed=True)
    m_rows.append((out[-1], "(2,1) run 1", ld_key["knn_merge_cand"]))
    _, (y, qid, nbr, coef, alpha), kw = calls21["ne_forces_scatter"]
    check(qid.shape[0] == half and int(qid[0]) == half, "B3: not the slice")
    got = ne_forces_scatter(y, qid, nbr, coef, alpha, **kw)
    again = ne_forces_scatter(y, qid, nbr, coef, alpha, **kw)
    scats, wsums = ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw)
    check(all(g.shape == (N, cfg.dim_ld) for g in got[0]),
          "B3 slice: fields not over all rows")
    for g, a in zip(got[0] + got[1], again[0] + again[1]):
        check(torch.equal(g, a), "B3 slice not bit-identical over launches")
    err_b3 = 0.0
    for g, w in zip(got[0] + got[1], scats + wsums):
        e = max_err(g, w)
        check(e <= TOL_FORCE_REL * float(w.abs().max()),
              f"B3 slice err {e}")
        err_b3 = max(err_b3, e)
    log(f"[m2] B3, rows {half}-{N - 1}, fields over {N} rows: bit-identical "
        f"over two launches; max abs err {err_b3:.3e} (tol {TOL_FORCE_REL} "
        "of each field's largest entry)")
    entry("ne_forces_scatter_slice", "src/repro_torch/csrc/ne_forces.cu",
          "src/repro/kernels/ne_forces/kernel.py:451",
          lambda: ne_forces_scatter(y, qid, nbr, coef, alpha, **kw),
          lambda: ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw), 50,
          nbytes(y, qid, nbr, coef, alpha, *scats, *wsums),
          20.0 * nbr.numel(), err_b3, None, tag="[m2]", graphed=True)
    m_rows.append((out[-1], "(2,1) run 1", "ne_forces_scatter"))
    del calls21, calls21q, yq, got, again, want, scats, wsums
    torch.cuda.empty_cache()

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
    share = {"hd_refine": launches[hd_key["knn_merge_cand"]] / ITERS,
             "sigma_refresh": 1.0 / cfg.sigma_refresh_every}
    per_step = 0.0
    for name, fn in phase.items():
        ms = wall_ms(fn)
        per_step += ms * share.get(name, 1.0)
        log(f"[e] phase {name}: {ms:.3f} ms per call, runs in "
            f"{share.get(name, 1.0):.3f} of steps")
    log(f"    phases add up to {per_step:.3f} ms per step; the main path "
        f"took {t_run / ITERS * 1e3:.3f} ms per step")

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
    log(f"[f] starts {time.perf_counter() - t_start:.1f}s into the script")
    # (flags, the launch counters its F_ITERS steps must move; every other
    # counter must stay at 0)
    b2 = {hd_key["knn_merge_cand"], ld_key["knn_merge_cand"]}
    b3 = {"ne_forces_scatter"}
    paths = {
        "default": ({}, b2 | b3),
        "gather_fused=False": (dict(gather_fused=False),
                               {"pairwise_sqdist",
                                edges_key("ne_forces", cfg.dim_ld),
                                "segment_sum"}),
        "scatter_fused=False": (dict(scatter_fused=False),
                                b2 | {edges_key("ne_forces_gather",
                                                cfg.dim_ld), "segment_sum"}),
        "merge_fused=False": (dict(merge_fused=False),
                              set(b1_key.values()) | b3),
        "c_hd_rev=4": (dict(c_hd_rev=4), b2 | b3),
        "cand_fused=False": (dict(cand_fused=False),
                             {hd_key["knn_merge"], ld_key["knn_merge"]}
                             | b3),
        "default, again": ({}, b2 | b3),   # brackets the flag paths' times
    }
    exact_ops = {"pairwise_sqdist_gather", "knn_merge_cand", "pairwise_sqdist",
                 "knn_merge"}

    @contextlib.contextmanager
    def warp_route():
        """B5 and B7 on their warp route whatever the width (the kernel
        their rounds and staged routes are held to)."""
        saved = force_ops.edges_route
        force_ops.edges_route = lambda *_: "warp"
        try:
            yield
        finally:
            force_ops.edges_route = saved

    def flat(v):
        return [t for x in v for t in flat(x)] if isinstance(v, tuple) \
            else [v]

    def held(key, op, args, kw, quantised):
        """Kernel vs plain version on one recorded call; returns the max
        abs error.  The scoring kernels exact on quantised inputs, their
        distances within TOL_SQDIST_REL on real ones (ids and flags may
        part at a near tie there); forces within TOL_FORCE_REL; the segment
        sum bit for bit against the CPU's sequential index_add_.  B5 and B7
        also: one launch of the route of their width and nothing else, the
        outputs bit for bit the warp route's (int32 views), the edges exact
        on quantised inputs (each edge is the plain version's arithmetic;
        only the aggregates and wsums sum in another order)."""
        if op in EDGE_OPS:
            key_e = edges_key(op, args[0].shape[1])
            before = dict(kernels.LAUNCHES)
            got = flat(getattr(funcsne.KERNELS, op)(*args, **kw))
            moved = {k_: v_ - before[k_] for k_, v_ in kernels.LAUNCHES.items()
                     if v_ != before[k_]}
            check(moved == {key_e: 1}, f"{key}: launched {moved}, one launch "
                  f"of {key_e} expected")
            with warp_route():
                warp = flat(getattr(funcsne.KERNELS, op)(*args, **kw))
            check(all((g is None and w is None) or torch.equal(
                g.view(torch.int32), w.view(torch.int32))
                for g, w in zip(got, warp)),
                f"{key}: {key_e} not bit for bit the warp route's")
        else:
            got = flat(getattr(funcsne.KERNELS, op)(*args, **kw))
        if op == "segment_sum":
            want = [segment_sum_ref(args[0].cpu(), args[1].cpu(), args[2])
                    .to(dev)]
        else:
            want = flat(getattr(funcsne.PLAIN, op)(*args, **kw))
        err = 0.0
        for g, w in zip(got, want):
            check((g is None) == (w is None), f"{key}: None outputs differ")
            if w is None:
                continue
            if op == "segment_sum":
                check(torch.equal(g, w), f"{key}: not the CPU's sequential "
                      "index_add_ bit for bit")
            elif op in exact_ops and quantised:
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
            elif op in EDGE_OPS and quantised and g.ndim == 3:
                check(torch.equal(g, w), f"{key}: edges not exact on "
                      "quantised input")
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

    # B1 on merge_fused=False's path: its HD call behind the gate (the
    # ring) and its LD call of list and candidates (the lanes), on the real
    # final state; then the HD call on 783 of X's columns and on a copy of
    # X that starts 4 bytes past 16 (the warp route; no path runs them)
    unf = f_rec["merge_fused=False"].calls
    for mode in ("hd", "ld"):
        _, (x_u, qid_u, cand_u), _ = unf[f"pairwise_sqdist_gather_{mode}"]
        b1_entry(f"merge_fused_false_{mode}", x_u, qid_u, cand_u,
                 f_launch["merge_fused=False"][b1_key[mode]], "[f]")
    _, (_, qid_u, cand_u), _ = unf["pairwise_sqdist_gather_hd"]
    b1_entry("m783", X[:, :783].contiguous(), qid_u, cand_u, 0, "[f]")
    x_mis = torch.empty(N * DIM + 1, device=dev)[1:].view(N, DIM)
    x_mis.copy_(X)
    check(gather_key(DIM, x_mis.data_ptr() % 16 == 0)
          == "pairwise_sqdist_gather", "B1 on a misaligned X: not the warp "
          "route")
    b1_entry("misaligned", x_mis, qid_u, cand_u, 0, "[f]")
    del x_mis, x_u, qid_u, cand_u, unf

    def flag_window(label, name, match):
        """Where a step of the flag path ``label`` spends its device time:
        a 20-step profiler window from the main path's final state, with
        the share of ``name``'s kernels (kernel names holding ``match``)."""
        win = funcsne.make_chunked_step(
            dataclasses.replace(cfg, **paths[label][0]), 20,
            schedule=funcsne.default_schedule, n_iter=ITERS + F_ITERS)
        win(st, X, hp)                     # warm-up, untimed
        kernels.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            win(st, X, hp)
            torch.cuda.synchronize()
        rows_w = [(e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        del prof
        busy_w = sum(r[1] for r in rows_w)
        mine = [r for r in rows_w if match in r[0]]
        mine_ms = sum(r[1] for r in mine)
        check(mine_ms > 0, f"the profiler saw no {name} kernel in {label}")
        log(f"[f] profiler, 20 steps of {label}: device busy "
            f"{busy_w / 20:.4f} ms/step, {name} {mine_ms / 20:.4f} ms/step "
            f"({mine_ms / busy_w:.1%}; launches "
            f"{ {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_} }; "
            + ", ".join(f"{k_[:40]} {t_:.4f} ms in {n_} events"
                        for k_, t_, n_ in mine)
            + f"); the path ran {1e3 / f_sps[label]:.3f} ms/step of wall "
            f"time in its {F_ITERS} steps, so the device idles about "
            f"{1 - busy_w / 20 / (1e3 / f_sps[label]):.1%}; device time by "
            "kernel:")
        for key, ms, cnt in sorted(rows_w, key=lambda r: -r[1])[:8]:
            log(f"    {ms:9.3f} ms  {cnt:5d}x  {key[:90]}")

    # where a flag path's step spends its device time: merge_fused=False
    # (B1), scatter_fused=False (B5), gather_fused=False (B7)
    flag_window("merge_fused=False", "B1", "sqdist_gather")
    flag_window("scatter_fused=False", "B5",
                EDGE_KERNELS[edges_route(cfg.dim_ld)])
    flag_window("gather_fused=False", "B7",
                EDGE_KERNELS[edges_route(cfg.dim_ld)])

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
          tag="[f]", graphed=True)
    del q, c, out_6
    b7 = [f_rec["gather_fused=False"].calls[f"ne_forces_{i}"][1:]
          for i in range(3)]
    b7_out = [ne_forces_ref(*a, **kw) for a, kw in b7]
    key7 = edges_key("ne_forces", cfg.dim_ld)
    entry(key7, "src/repro_torch/csrc/ne_forces.cu",
          "src/repro/kernels/ne_forces/kernel.py:70",
          lambda: [ne_forces(*a, **kw) for a, kw in b7],
          lambda: [ne_forces_ref(*a, **kw) for a, kw in b7], 50,
          nbytes(*[t for a, _ in b7 for t in a], *flat(tuple(
              t for o in b7_out for t in o))),
          20.0 * sum(a[2].numel() for a, _ in b7),
          max(f_err[f"ne_forces_{i}"] for i in range(3)),
          f_launch["gather_fused=False"][key7], tag="[f]", graphed=True)
    log("    (B7: the three launches of one step, timed together)")
    _, (x5, q5, n5, c5, a5), kw5 = f_rec["scatter_fused=False"].calls[
        "ne_forces_gather"]
    o5 = [t for t in flat(ne_forces_gather_ref(x5, q5, n5, c5, a5, **kw5))
          if t is not None]
    key5 = edges_key("ne_forces_gather", cfg.dim_ld)
    entry(key5, "src/repro_torch/csrc/ne_forces.cu",
          "src/repro/kernels/ne_forces/kernel.py:243",
          lambda: ne_forces_gather(x5, q5, n5, c5, a5, **kw5),
          lambda: ne_forces_gather_ref(x5, q5, n5, c5, a5, **kw5), 50,
          nbytes(x5, q5, n5, c5, a5, *o5), 20.0 * n5.numel(),
          f_err["ne_forces_gather"],
          f_launch["scatter_fused=False"][key5], tag="[f]", graphed=True)

    _, (ix, vx, nx), _ = f_rec["scatter_fused=False"].calls["segment_sum"]
    out_s = torch.empty((nx, vx.shape[1]), device=dev)
    entry("segment_sum", "src/repro_torch/csrc/segment_sum.cu",
          "src/repro/core/funcsne.py:732",
          lambda: segment_sum(ix, vx, nx), lambda: segment_sum_ref(ix, vx, nx),
          50, nbytes(ix, vx, out_s), 1.0 * vx.numel(), f_err["segment_sum"],
          f_launch["scatter_fused=False"]["segment_sum"],
          library=lambda: torch.zeros_like(out_s).index_add_(0, ix, vx),
          tag="[f]")
    first = segment_sum(ix, vx, nx)
    check(torch.equal(first.cpu(), segment_sum_ref(ix.cpu(), vx.cpu(), nx)),
          "segment_sum differs from the sequential index_add_ on the CPU")
    check(torch.equal(first, segment_sum(ix, vx, nx)),
          "segment_sum not bit-identical over two calls")
    # where its time goes: the four passes' device time from a profiler
    # trace of full calls (by kernel name), the whole call beside
    # index_add_ from CUDA graphs (device time without the host's
    # launches); the run lengths the order-and-sum pass meets
    work_s = torch.empty(seg_ops.work_ints(nx, ix.shape[0], vx.shape[1]),
                         dtype=torch.int32, device=dev)
    seg_ops.launch(ix, vx, nx, out_s, work_s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            seg_ops.launch(ix, vx, nx, out_s, work_s)
        torch.cuda.synchronize()
    pass_ms = dict.fromkeys(SEG_PASSES, 0.0)
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            for name, kerns in SEG_PASSES.items():
                if any(k_ in ev.key for k_ in kerns):
                    pass_ms[name] += ev.self_device_time_total / 1e3 / 20
    del prof
    full_g = graph_ms(lambda: seg_ops.launch(ix, vx, nx, out_s, work_s), 20)
    lib_g = graph_ms(lambda: torch.zeros_like(out_s).index_add_(0, ix, vx), 20)
    runs = torch.bincount(ix.long(), minlength=nx).float()
    log(f"    segment_sum: {ix.shape[0]} {str(ix.dtype)[6:]} ids, rows of "
        f"{vx.shape[1]} into {nx}; bit-identical to the CPU's sequential "
        f"index_add_ and over two calls; passes from a profiler trace of 20 "
        f"calls: " + ", ".join(f"{k} {v:.4f}" for k, v in pass_ms.items())
        + f" ms; the whole call from CUDA graphs {full_g:.4f} ms against "
        f"index_add_'s {lib_g:.4f} ({full_g / lib_g:.2f}x); run lengths: "
        f"longest {int(runs.max())}, 99th percentile "
        f"{float(torch.quantile(runs, 0.99)):.0f}, mean "
        f"{float(runs.mean()):.1f}, empty rows {int((runs == 0).sum())}")
    check(all(v > 0 for v in pass_ms.values()),
          f"segment_sum: a pass the profiler did not see: {pass_ms}")
    del out_s, work_s, first, runs
    # the routes the step's ids do not take: a row past a group's
    # shared-memory capacity (every 64th id sent to row 0, as clamped -1
    # slots are), at d = 2 (values staged) and at d = 8 (values gathered);
    # each against the CPU's sequential index_add_ and over two calls
    pile = ix.clone()
    pile[::64] = 0
    for d_p in (2, 8):
        v_p = vx if d_p == 2 else torch.randn(
            (ix.shape[0], d_p), generator=torch.Generator(device=dev)
            .manual_seed(d_p), device=dev)
        got = segment_sum(pile, v_p, nx)
        check(torch.equal(got.cpu(), segment_sum_ref(pile.cpu(), v_p.cpu(),
                                                     nx)),
              f"segment_sum, pile on row 0, d={d_p}: not the CPU's "
              "sequential index_add_")
        check(torch.equal(got, segment_sum(pile, v_p, nx)),
              f"segment_sum, pile on row 0, d={d_p}: two calls differ")
        log(f"    segment_sum, every 64th id on row 0 ({int((pile == 0).sum())}"
            f" ids there), d = {d_p}: bit-identical to the CPU's sequential "
            f"index_add_ and over two calls; "
            f"{time_ms(lambda: segment_sum(pile, v_p, nx), 20):.4f} ms, "
            f"index_add_ {time_ms(lambda: torch.zeros((nx, d_p), device=dev).index_add_(0, pile, v_p), 20):.4f} ms")
        del got, v_p
    del pile

    def b4_entry(name, call, err, count, tag, graphed=False):
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
              3.0 * scored * x.shape[1], err, count, tag=tag,
              graphed=graphed)
        log(f"    {name}: x {tuple(x.shape)} K={cur_idx.shape[1]} C="
            f"{cand.shape[1]}, {scored} rows scored "
            f"({float(valid.float().mean()):.3f} of candidates new)")

    legacy = f_rec["cand_fused=False"].calls
    for mode in ("hd", "ld"):
        b4_entry(hd_key["knn_merge"] if mode == "hd" else f"knn_merge_{mode}",
                 legacy[f"knn_merge_{mode}"],
                 f_err[f"knn_merge_{mode}"],
                 f_launch["cand_fused=False"][
                     ld_key["knn_merge"] if mode == "ld"
                     else hd_key["knn_merge"]],
                 "[f]",
                 graphed=True)
    # B4's warp route on MNIST's rows: the same call on the first 783
    # columns (M % 4 != 0, no ring), held on the quantised and the real X
    _, args_w, kw_w = legacy["knn_merge_hd"]
    err_w = {}
    for x_w, quantised in ((Xq, True), (X, False)):
        x_w = x_w[:, :783].contiguous()
        kernels.reset_launches()
        err_w[quantised] = held("knn_merge_hd M=783", "knn_merge",
                                (x_w,) + args_w[1:], kw_w, quantised)
        check(merge_key("knn_merge", 783, "hd", cfg.k_hd, c_hd_of(cfg))
              == "knn_merge_hd" and kernels.LAUNCHES["knn_merge_hd"] == 1
              and sum(kernels.LAUNCHES.values()) == 1,
              f"B4 at 783 columns launched {kernels.LAUNCHES}")
        del x_w
    log(f"[f] B4's warp route (knn_merge_hd) on the cand_fused=False HD call "
        f"at 783 columns: exact on the quantised X, max abs err "
        f"{err_w[False]:.3e} on the real X (distances within "
        f"{TOL_SQDIST_REL} relative)")

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
    gate_share = f_launch["cand_fused=False"][hd_key["knn_merge"]] / F_ITERS
    per_step = (draw_ms["key chain + gate (host)"]
                + gate_share * draw_ms["HD candidates"]
                + draw_ms["LD candidates + negatives"])
    log("[f] threefry draws of a cand_fused=False step (wall ms, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in draw_ms.items())
        + f"; {per_step:.3f} ms per step with the gate firing on "
        f"{gate_share:.2f} of steps")

    # ---- (g) nearest-neighbour descent ------------------------------------
    log(f"[g] starts {time.perf_counter() - t_start:.1f}s into the script")
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
    want_g = {b1_key["hd"]: 1, hd_key["knn_merge"]: len(hist)}
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
    b4_entry(f"{hd_key['knn_merge']}_nnd", recr.calls["knn_merge_hd"], g_err,
             launches_g[hd_key["knn_merge"]], "[g]", graphed=True)
    b1_entry("nnd_init", *recr.calls["pairwise_sqdist_gather_hd"][1],
             launches_g[b1_key["hd"]], "[g]")
    del recr

    # the same run again under the profiler (device busy an iteration, B4's
    # mean launch and share over the run), recording the last iteration's
    # B4 call, which is then held and timed as the first one above
    late = {}

    def rec_late(*args, **kw):
        late["call"] = ("knn_merge", args, kw)
        return funcsne.KERNELS.knn_merge(*args, **kw)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # device activity only, its events summed by name (_device_ms): the
    # host ops of a whole NND run under the profiler, and key_averages'
    # event tree over them, cost far more wall time than the run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, hist_p = nnd.nnd(X, ncfg, nkey, max_iter=NND_ITERS, tol=1e-3,
                               device=dev,
                               ops=funcsne.KERNELS._replace(knn_merge=rec_late))
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    check(hist_p == hist and dict(kernels.LAUNCHES) == launches_g,
          "NND under the profiler: another history or other launches")
    by_name = _device_ms(prof)
    del prof
    log(f"[g] the profiled NND run and its trace took "
        f"{time.perf_counter() - t0:.1f}s")
    busy_g = sum(t_ for t_, _ in by_name.values())
    b4_ms = sum(t_ for k_, (t_, _) in by_name.items() if "knn_merge" in k_)
    b4_n = sum(n_ for k_, (_, n_) in by_name.items() if "knn_merge" in k_)
    check(b4_ms > 0, "the profiler saw no B4 kernel in NND")
    n_it = len(hist_p)
    log(f"[g] profiler over the whole run ({n_it} iterations): device busy "
        f"{busy_g / n_it:.4f} ms an iteration against {wall_p / n_it * 1e3:.3f}"
        f" ms of wall time with the profiler on ({t_nnd / n_it * 1e3:.3f} "
        f"without), so the device idles about "
        f"{1 - busy_g / n_it / (t_nnd / n_it * 1e3):.1%}; B4 "
        f"{b4_ms / launches_g[hd_key['knn_merge']]:.4f} ms a launch on the "
        f"run's mean ({b4_n} events in the trace), {b4_ms / busy_g:.1%} of "
        f"the device time")
    g_late = held("knn_merge nnd late", *late["call"], False)
    b4_entry(f"{hd_key['knn_merge']}_nnd_late", late["call"], g_late,
             launches_g[hd_key["knn_merge"]], "[g]", graphed=True)
    del late

    # ---- (h) B8 alone ------------------------------------------------------
    log(f"[h] starts {time.perf_counter() - t_start:.1f}s into the script")
    def b8_rows(name, fns, reps, bytes_, flops, errs, library=None,
                tag="[h]", timer=time_ms):
        """Time B8's kernels in turns (plain, tensor-core, SIMT,
        tensor-core) on one card, then the library call, the kernels and
        the library call with ``timer``; one row per kernel in ``fns``
        (route -> call: "wgmma" or "tf32" the tensor-core kernel of the
        dtype, "simt"; "plain" the plain version), launches filled in by
        phase (i).  The bound is the same work's least time: bf16 products
        at the bf16 rate, or float32-accurate ones as three TF32 products
        each (3xTF32) at the TF32 rate."""
        plain_ms = time_ms(fns["plain"], max(2, reps // 10))
        tc = "wgmma" if "wgmma" in fns else "tf32"
        t = {tc: [timer(fns[tc], reps)],
             "simt": [timer(fns["simt"], max(2, reps // 5))]}
        t[tc].append(timer(fns[tc], reps))
        lib_ms = None if library is None else timer(library, reps)
        if fns["dtype"] == torch.bfloat16:
            b_ms, b_by = bound(bytes_, flops, BF16_FLOPS_PER_S)
        else:
            b_ms, b_by = bound(bytes_, 3.0 * flops, TF32_FLOPS_PER_S)
        parts = []
        for route, ms in t.items():
            mean = sum(ms) / len(ms)
            row = name if route == tc else f"{name}_simt"
            b8[row] = {"name": row, "route": "cuda",
                       "source": B8_SOURCE[route], "replaces": B8_REPLACES,
                       "launches": 0, "max_abs_err": errs[route], "ms": mean,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": lib_ms}
            b8_route[row] = route
            out.append(b8[row])
            parts.append(f"{B8_LABEL[route]} "
                         + " / ".join(f"{m:.4f}" for m in ms) + " ms ("
                         f"{flops / mean / 1e9:.1f} TFLOP/s, {b_ms / mean:.1%}"
                         " of the bound)")
        log(f"{tag} {name}: " + "; ".join(parts) + f"; bound {b_ms:.4f} ms "
            f"by {b_by}; plain {plain_ms:.3f} ms"
            + ("" if lib_ms is None else f"; SDPA {lib_ms:.4f} ms")
            + f"; SIMT / tensor-core {t['simt'][0] / min(t[tc]):.1f}x"
            + ("" if lib_ms is None else
               f"; tensor-core / SDPA {min(t[tc]) / lib_ms:.2f}x"))

    b8, b8_route = {}, {}          # B8's rows by name, and their kernel
    gen = torch.Generator(device=dev).manual_seed(7)
    for name, b, hq, hkv, s_len, d_h, dt, cap, win, reps in ATTN_CASES:
        q, k, v = (torch.randn((b, h, s_len, d_h), generator=gen, device=dev)
                   .to(dt) for h in (hq, hkv, hkv))
        route = flash_ops.kernel_route(dt, d_h)
        check(route == ("wgmma" if dt == torch.bfloat16 else "tf32"),
              f"{name}: B8 route {route}")
        kernels.reset_launches()
        got = flash_attention(q, k, v, softcap=cap, window=win)
        check(kernels.LAUNCHES[f"flash_attention_{route}"] == 1 and sum(
            kernels.LAUNCHES.values()) == 1, f"{name}: launches "
            f"{ {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_} }")
        want = flash_attention_ref(q, k, v, softcap=cap, window=win)
        errs = {route: attn_close(got, want, name)}
        kw = dict(scale=d_h ** -0.5, softcap=cap, window=win)
        fns = {"plain": lambda q=q, k=k, v=v, cap=cap, win=win:
               flash_attention_ref(q, k, v, softcap=cap, window=win),
               "dtype": dt}
        buf = torch.empty_like(q)
        fns["simt"] = lambda q=q, k=k, v=v, buf=buf, kw=kw: \
            flash_ops.launch_simt(q, k, v, buf, **kw)
        fns[route] = lambda q=q, k=k, v=v, buf=buf, kw=kw, r=route: \
            getattr(flash_ops, f"launch_{r}")(q, k, v, buf, **kw)
        fns["simt"]()
        errs["simt"] = attn_close(buf, want, f"{name} SIMT")
        lib = None
        if not cap and not win:
            lib = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        b8_rows(name, fns, reps, nbytes(q, k, v, got),
                4.0 * b * hq * d_h * attn_pairs(s_len, win), errs,
                library=lib)
        log(f"    {name}: B {b}, S {s_len}, Hq {hq}, Hkv {hkv}, D {d_h}, "
            f"{str(dt)[6:]}, softcap {cap}, window {win}: the "
            f"{B8_LABEL[route]} kernel through flash_attention, max abs err "
            f"{errs[route]:.3e} against the plain version (the SIMT kernel "
            f"{errs['simt']:.3e})")
        del q, k, v, got, want, buf, fns
    for name, b, hq, hkv, s_len, d_h, d_v, dt, cap, win, layout in \
            ATTN_CHECKS:
        shape = (lambda h, w: (b, s_len, h, w)) if layout == "bshd" else \
            (lambda h, w: (b, h, s_len, w))
        q, k, v = (torch.randn(shape(h, w), generator=gen, device=dev).to(dt)
                   for h, w in ((hq, d_h), (hkv, d_h), (hkv, d_v)))
        route = flash_ops.kernel_route(dt, d_h, d_v)
        kernels.reset_launches()
        if layout == "bshd":
            got = flash_chunked(q, k, v, scale=d_h ** -0.5, cap=cap,
                                window=win).transpose(1, 2)
            q, k, v = (t_.transpose(1, 2) for t_ in (q, k, v))
        else:
            got = flash_attention(q, k, v, softcap=cap, window=win)
        check(kernels.LAUNCHES[f"flash_attention_{route}"] == 1
              and sum(kernels.LAUNCHES.values()) == 1,
              f"{name}: launches {kernels.LAUNCHES}")
        err = attn_close(got, flash_attention_ref(q, k, v, softcap=cap,
                                                  window=win), name)
        log(f"[h] {name}: B {b}, S {s_len}, Hq {hq}, Hkv {hkv}, D {d_h}, "
            f"Dv {d_v}, {str(dt)[6:]}, softcap {cap}, window {win}, {layout} "
            f"layout "
            f"(q strides {tuple(q.stride())}): the {B8_LABEL[route]} kernel "
            f"through the routed call, max abs err {err:.3e} against the "
            "plain version")
        del q, k, v, got
    torch.cuda.empty_cache()

    # ---- (i) MusicGen-large's hidden states into an 8-D FUnc-SNE ------------
    log(f"[i] starts {time.perf_counter() - t_start:.1f}s into the script")
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
    want = flash_chunked_ref(q, k, v, **kw)
    qt, kt, vt = (t_.transpose(1, 2) for t_ in (q, k, v))
    buf = torch.empty_like(qt)
    b_kw = dict(scale=kw["scale"], softcap=kw["cap"], window=kw["window"])
    errs = {"wgmma": attn_close(flash_chunked(q, k, v, **kw), want,
                                "B8 at the latents shape")}
    flash_ops.launch_simt(qt, kt, vt, buf, **b_kw)
    errs["simt"] = attn_close(buf.transpose(1, 2), want,
                              "B8 SIMT at the latents shape")
    b_, s_, hq_, d_ = q.shape
    # at this shape a launch takes the host longer than the kernel takes
    # the card, so the kernels and SDPA are timed from CUDA graphs
    b8_rows("flash_attention_latents",
            {"plain": lambda: flash_chunked_ref(q, k, v, **kw),
             "wgmma": lambda: flash_ops.launch_wgmma(qt, kt, vt, buf, **b_kw),
             "simt": lambda: flash_ops.launch_simt(qt, kt, vt, buf, **b_kw),
             "dtype": q.dtype}, 50,
            nbytes(q, k, v) + q.numel() * q.element_size(),
            4.0 * b_ * hq_ * d_ * attn_pairs(s_, 0), errs,
            library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), tag="[i]",
            timer=graph_ms)
    log(f"    host-issued, one call at a time: the tensor-core kernel "
        f"through flash_chunked {time_ms(lambda: flash_chunked(q, k, v, **kw), 50):.4f}"
        f" ms, the SIMT kernel "
        f"{time_ms(lambda: flash_ops.launch_simt(qt, kt, vt, buf, **b_kw), 50):.4f} ms")
    log(f"    (layer 0's call: q, k, v {tuple(q.shape)} in the (B, S, H, D) "
        f"layout, strides {q.stride()}; max abs err {errs['wgmma']:.3e}, the "
        f"SIMT kernel {errs['simt']:.3e})")
    del want, qt, kt, vt, buf
    del h_k, h_p, x0, calls, q, k, v

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H = embed_latents.latents(model, params, frames, dev)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    launches_i = dict(kernels.LAUNCHES)
    n_batches = -(-N_SEQ // embed_latents.BATCH)
    want_i = {"flash_attention_wgmma": cfg_m.n_layers * n_batches}
    check(launches_i == {k_: want_i.get(k_, 0) for k_ in launches_i},
          f"forward launches {launches_i}, expected {want_i}")
    check(H.shape == (N_SEQ, cfg_m.d_model) and bool(torch.isfinite(H).all()),
          "latents not finite")
    # the same forward in float32 compute, one batch: B8's float32
    # tensor-core kernel on a path of its own (float32 at D 64)
    x0 = torch.from_numpy(frames[:embed_latents.BATCH]).to(dev)
    kernels.reset_launches()
    h32 = LMModel(dataclasses.replace(cfg_m, compute_dtype="float32")) \
        .hidden_states(params, x0)
    torch.cuda.synchronize()
    launches_f32 = dict(kernels.LAUNCHES)
    want_f32 = {"flash_attention_tf32": cfg_m.n_layers}
    check(launches_f32 == {k_: want_f32.get(k_, 0) for k_ in launches_f32},
          f"float32 forward launches {launches_f32}, expected {want_f32}")
    check(h32.dtype == torch.float32 and bool(torch.isfinite(h32).all()),
          "float32 hidden states not finite")
    log(f"[i] one batch in float32 compute: B8's float32 tensor-core kernel "
        f"launched {launches_f32['flash_attention_tf32']} times, its SIMT "
        f"kernel 0, nothing else; hidden states finite")
    del h32, x0
    # the SIMT kernel's own path: the config's smoke variant (float32
    # compute, heads of 32, the width the CPU tests run), one batch
    cfg_s = smoke_variant(cfg_m)
    model_s = LMModel(cfg_s)
    params_s = model_s.init_params(0, device=dev)
    x_s = torch.from_numpy(embed_latents.make_frames(
        embed_latents.BATCH, cfg_s.d_model)[0]).to(dev)
    kernels.reset_launches()
    h_s = model_s.hidden_states(params_s, x_s)
    torch.cuda.synchronize()
    launches_s = dict(kernels.LAUNCHES)
    want_s = {"flash_attention_simt": cfg_s.n_layers}
    check(launches_s == {k_: want_s.get(k_, 0) for k_ in launches_s},
          f"smoke-variant forward launches {launches_s}, expected {want_s}")
    check(bool(torch.isfinite(h_s).all()), "smoke-variant hidden states")
    # the same batch with B8's calls recorded, and through the plain
    # flash_chunked: the SIMT kernel held on this path, and timed at its
    # shape (from CUDA graphs: a launch takes the host longer than the
    # kernel takes the card)
    calls_s = []

    def rec_s(q, k, v, **kw):
        calls_s.append((q, k, v, kw))
        return flash_chunked(q, k, v, **kw)
    LMModel(cfg_s, attention=rec_s).hidden_states(params_s, x_s)
    h_sp = LMModel(cfg_s, attention=flash_chunked_ref).hidden_states(
        params_s, x_s)
    rel_s = float((h_s - h_sp).norm() / h_sp.norm())
    check(rel_s <= TOL_LATENTS, f"smoke-variant hidden states vs plain: {rel_s}")
    err_s = max(attn_close(flash_chunked(q, k, v, **kw),
                           flash_chunked_ref(q, k, v, **kw),
                           f"B8 SIMT at the smoke shape, layer {i_}")
                for i_, (q, k, v, kw) in enumerate(calls_s))
    q, k, v, kw = calls_s[0]
    qt, kt, vt = (t_.transpose(1, 2) for t_ in (q, k, v))
    buf = torch.empty_like(qt)
    b_kw = dict(scale=kw["scale"], softcap=kw["cap"], window=kw["window"])
    b_, s_, hq_, d_ = q.shape
    flops_s = 4.0 * b_ * hq_ * d_ * attn_pairs(s_, kw["window"])
    bytes_s = nbytes(q, k, v) + q.numel() * q.element_size()
    b_ms, b_by = bound(bytes_s, 3.0 * flops_s, TF32_FLOPS_PER_S)
    simt_ms = graph_ms(lambda: flash_ops.launch_simt(qt, kt, vt, buf,
                                                     **b_kw), 50)
    lib_s = None
    if not kw["cap"] and not kw["window"]:
        lib_s = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 50)
    plain_s = time_ms(lambda: flash_chunked_ref(q, k, v, **kw), 10)
    row = "flash_attention_smoke_simt"
    b8[row] = {"name": row, "route": "cuda", "source": B8_SOURCE["simt"],
               "replaces": B8_REPLACES, "launches": 0, "max_abs_err": err_s,
               "ms": simt_ms, "plain_ms": plain_s, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib_s}
    b8_route[row] = "smoke"
    out.append(b8[row])
    log(f"[i] {cfg_s.name} ({cfg_s.n_layers} layers, {cfg_s.n_heads} heads "
        f"of {cfg_s.resolved_head_dim}, {cfg_s.compute_dtype}), one batch: "
        f"B8's SIMT kernel launched {launches_s['flash_attention_simt']} "
        f"times, nothing else; hidden states finite, {rel_s:.3e} from the "
        f"plain flash_chunked's (relative Frobenius, tol {TOL_LATENTS}); "
        f"each layer's B8 call within {err_s:.3e} of the plain version "
        f"(TOL_ATTN_F32); the SIMT kernel at this shape (q {tuple(q.shape)}, "
        f"(B, S, H, D)) {simt_ms:.4f} ms from CUDA graphs, bound "
        f"{b_ms:.4f} ms by {b_by}, plain {plain_s:.3f} ms"
        + ("" if lib_s is None else f", SDPA {lib_s:.4f} ms"))
    del model_s, params_s, x_s, h_s, h_sp, calls_s, q, k, v, qt, kt, \
        vt, buf
    # launches on the path each row's shape runs: the SIMT kernel runs
    # only on the smoke variant's path, so its rows at the full shapes
    # (timing only) count none
    count_of = {"wgmma": launches_i["flash_attention_wgmma"],
                "tf32": launches_f32["flash_attention_tf32"],
                "simt": 0, "smoke": launches_s["flash_attention_simt"]}
    for name, row in b8.items():
        row["launches"] = count_of[b8_route[name]]
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
        f"{n_tok / t_fwd:.0f} tokens/s; B8's tensor-core kernel launched "
        f"{launches_i['flash_attention_wgmma']} times ({cfg_m.n_layers} per "
        f"batch), its SIMT kernel 0, nothing else; latents finite")
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
    i_b1 = {mode: recr.calls[f"pairwise_sqdist_gather_{mode}"][1]
            for mode in ("hd", "ld")}
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

    # cand_fused=False on the latents: its HD merge is B4 on 16-wide rows,
    # B4's warp route.  One step on the grid, held; a chunk of CHUNK steps
    # from init_state with the launch counters set to 0 just before; one
    # step from the chunk's state on the real latents, held and timed
    c_ld_ne = cfg_ne.c_ld_non + cfg_ne.c_ld_hd + cfg_ne.c_ld_rand
    cfg_nf = dataclasses.replace(cfg_ne, cand_fused=False)
    key_nf = merge_key("knn_merge", cfg_ne.dim_hd, "hd", cfg_ne.k_hd,
                       c_hd_of(cfg_ne))
    check(key_nf == "knn_merge_hd", f"B4 at the latents' width: {key_nf}")
    recq = Recorder(funcsne, cfg_ne.dim_ld)
    funcsne.funcsne_step(cfg_nf, forced(st_q), Hq, hp_ne, ops=recq.ops)
    held("knn_merge_hd latents", *recq.calls["knn_merge_hd"], True)
    chunk_nf = funcsne.make_chunked_step(
        cfg_nf, CHUNK, schedule=funcsne.default_schedule, n_iter=500)
    kernels.reset_launches()
    s_nf, _, _ = chunk_nf(st_r, Hp, hp_ne)
    torch.cuda.synchronize()
    launches_nf = dict(kernels.LAUNCHES)
    want_nf = {"ne_forces_scatter", key_nf,
               merge_key("knn_merge", cfg_ne.dim_ld, "ld", cfg_ne.k_ld,
                         c_ld_ne)}
    check({k_ for k_, v_ in launches_nf.items() if v_} == want_nf,
          f"latents cand_fused=False chunk launched {launches_nf}, expected "
          f"{sorted(want_nf)}")
    check(bool(torch.isfinite(s_nf.Y).all()), "latents cand_fused=False: Y")
    recr = Recorder(funcsne, cfg_ne.dim_ld)
    funcsne.funcsne_step(cfg_nf, forced(s_nf), Hp, hp_ne, ops=recr.ops)
    call = recr.calls["knn_merge_hd"]
    b4_entry(f"{key_nf}_latents", call,
             held("knn_merge_hd latents", *call, False), launches_nf[key_nf],
             "[i]", graphed=True)
    log(f"[i] cand_fused=False on the latents, {CHUNK} steps: launches "
        f"{ {k_: v_ for k_, v_ in launches_nf.items() if v_} }; B4's warp "
        f"route exact on the grid, distances within {TOL_SQDIST_REL} on the "
        f"real latents")
    del Hp, Hq, recq, recr, st_q, st_r, st_k, st_p, s_nf, call

    kernels.reset_launches()
    acc, st_l, fit_s = embed_latents.embed_and_score(H, labels, dev)
    launches_l = dict(kernels.LAUNCHES)
    moved = {k_ for k_, v_ in launches_l.items() if v_}
    want_l = {gather_key(cfg_ne.dim_hd), gather_key(cfg_ne.dim_ld),
              "ne_forces_scatter",
              merge_key("knn_merge_cand", cfg_ne.dim_hd, "hd", cfg_ne.k_hd,
                        c_hd_of(cfg_ne)),
              merge_key("knn_merge_cand", cfg_ne.dim_ld, "ld", cfg_ne.k_ld,
                        c_ld_ne)}
    check(moved == want_l, f"fit launched {sorted(moved)}, expected "
          f"{sorted(want_l)}")
    check(bool(torch.isfinite(st_l.Y).all()), "8-D embedding not finite")
    # B1 at the fit's shapes (init_state's lists on the PCA-16 latents and
    # on its 8-D Y: the warp route and the lanes), on the real latents
    for mode in ("hd", "ld"):
        x_l, qid_l, cand_l = i_b1[mode]
        b1_entry(f"latents_{mode}", x_l, qid_l, cand_l,
                 launches_l[gather_key(x_l.shape[1])], "[i]")
    del i_b1, x_l, qid_l, cand_l
    log(f"[i] PCA 16 -> fit(dim_ld=8, n_iter=500): {500 / fit_s:.1f} steps/s "
        f"(init included); launches { {k_: v_ for k_, v_ in launches_l.items() if v_} }; "
        "one-shot 1-NN over 5 trials: "
        + ", ".join(f"{k_} {v_:.3f}" for k_, v_ in acc.items()))
    check(acc["funcsne8"] >= ACC_MIN, f"funcsne8 accuracy {acc['funcsne8']}")
    del H, st_l

    # ---- (j) the repairs: width (C1), snapshots (C2), determinism (C3) ------
    log(f"[j] starts {time.perf_counter() - t_start:.1f}s into the script")
    for d_ld in C1_WIDTHS:
        cfg_w = dataclasses.replace(cfg, dim_ld=d_ld)
        stq = funcsne.init_state(Xq, cfg_w, seed=1, device=dev)
        stq = stq._replace(Y=torch.round(stq.Y * 400.0) / 4.0)
        for flags in ({}, dict(scatter_fused=False), dict(gather_fused=False),
                      dict(merge_fused=False)):
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
            f"versions at this width (scoring exact on quantised inputs), "
            f"the segment sum bit for bit against the CPU's index_add_; "
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
        key_w = merge_key("knn_merge_cand", d_ld, "ld", cfg.k_ld, c_ld)
        check(moved == {hd_key["knn_merge_cand"], key_w, "ne_forces_scatter"},
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
        for flags in ({}, dict(scatter_fused=False), dict(gather_fused=False),
                      dict(merge_fused=False)):
            recs[tuple(flags)] = Recorder(funcsne, d_ld)
            kernels.reset_launches()
            funcsne.funcsne_step(dataclasses.replace(cfg_w, **flags),
                                 forced(s_k), X, hp, ops=recs[tuple(flags)].ops)
            recs_launch[tuple(flags)] = dict(kernels.LAUNCHES)
        # the segment sum at this width (its values gathered, not staged,
        # above d = 2), bit for bit against the CPU's sequential index_add_
        seg_err = max(held(f"segment_sum d={d_ld} {fl[0]}=False",
                           *recs[fl].calls["segment_sum"], False)
                      for fl in (("scatter_fused",), ("gather_fused",)))
        _, (ix, vx, nx), _ = recs[("scatter_fused",)].calls["segment_sum"]
        out_s = torch.empty((nx, vx.shape[1]), device=dev)
        entry(f"segment_sum_d{d_ld}", "src/repro_torch/csrc/segment_sum.cu",
              "src/repro/core/funcsne.py:732",
              lambda: segment_sum(ix, vx, nx),
              lambda: segment_sum_ref(ix, vx, nx), 20, nbytes(ix, vx, out_s),
              1.0 * vx.numel(), seg_err,
              recs_launch[("scatter_fused",)]["segment_sum"],
              library=lambda: torch.zeros_like(out_s).index_add_(0, ix, vx),
              tag="[j]")
        del ix, vx, out_s
        _, (y, qid, nbr, coef, alpha), kw = recs[()].calls["ne_forces_scatter"]
        o3 = ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw)
        entry(f"ne_forces_scatter_d{d_ld}", "src/repro_torch/csrc/ne_forces.cu",
              "src/repro/kernels/ne_forces/kernel.py:451",
              lambda: ne_forces_scatter(y, qid, nbr, coef, alpha, **kw),
              lambda: ne_forces_scatter_ref(y, qid, nbr, coef, alpha, **kw),
              20, nbytes(y, qid, nbr, coef, alpha, *o3[0], *o3[1]),
              (12.0 + 4.0 * d_ld) * nbr.numel(),
              held("B3", *recs[()].calls["ne_forces_scatter"], False),
              launches_w["ne_forces_scatter"], tag="[j]", graphed=True)
        # B2's LD refinement at this width: the lane route up to rows of
        # LANE_M floats, the warp route past them
        b2_entry(f"knn_merge_cand_ld_d{d_ld}",
                 recs[()].calls["knn_merge_cand_ld"],
                 held("B2 LD", *recs[()].calls["knn_merge_cand_ld"], False),
                 launches_w[key_w], "[j]", graphed=True)
        _, (x5, q5, n5, c5, a5), kw5 = recs[("scatter_fused",)].calls[
            "ne_forces_gather"]
        o5 = [t for t in flat(ne_forces_gather_ref(x5, q5, n5, c5, a5, **kw5))
              if t is not None]
        key5 = edges_key("ne_forces_gather", d_ld)
        entry(f"{key5}_d{d_ld}", "src/repro_torch/csrc/ne_forces.cu",
              "src/repro/kernels/ne_forces/kernel.py:243",
              lambda: ne_forces_gather(x5, q5, n5, c5, a5, **kw5),
              lambda: ne_forces_gather_ref(x5, q5, n5, c5, a5, **kw5), 20,
              nbytes(x5, q5, n5, c5, a5, *o5), (12.0 + 4.0 * d_ld) * n5.numel(),
              held("B5", *recs[("scatter_fused",)].calls["ne_forces_gather"],
                   False),
              recs_launch[("scatter_fused",)][key5], tag="[j]")
        b7w = [recs[("gather_fused",)].calls[f"ne_forces_{i}"][1:]
               for i in range(3)]
        o7 = [ne_forces_ref(*a, **kw_) for a, kw_ in b7w]
        key7 = edges_key("ne_forces", d_ld)
        entry(f"{key7}_d{d_ld}", "src/repro_torch/csrc/ne_forces.cu",
              "src/repro/kernels/ne_forces/kernel.py:70",
              lambda: [ne_forces(*a, **kw_) for a, kw_ in b7w],
              lambda: [ne_forces_ref(*a, **kw_) for a, kw_ in b7w], 20,
              nbytes(*[t for a, _ in b7w for t in a],
                     *flat(tuple(t for o in o7 for t in o))),
              (12.0 + 4.0 * d_ld) * sum(a[2].numel() for a, _ in b7w),
              max(held("B7", "ne_forces", a, kw_, False) for a, kw_ in b7w),
              recs_launch[("gather_fused",)][key7], tag="[j]")
        # B1's LD call of merge_fused=False at this width (list and
        # candidates): the lanes up to LANE_M floats, the warp route past
        key_u = gather_key(d_ld)
        check(recs_launch[("merge_fused",)][key_u] == 1,
              f"d={d_ld} merge_fused=False step: B1 LD launches "
              f"{recs_launch[('merge_fused',)]}")
        b1_entry(f"merge_fused_false_ld_d{d_ld}",
                 *recs[("merge_fused",)].calls["pairwise_sqdist_gather_ld"][1],
                 recs_launch[("merge_fused",)][key_u], "[j]")
        log(f"    (at dim_ld {d_ld}, a "
            + ("runtime width in tiles of 4" if d_ld not in (8, 16, 32)
               else "compile-time width")
            + f": B3 launches over the {CHUNK}-step chunk; B5 and B7 over "
            f"one step of their paths, B7's three timed together; the "
            f"segment sum over one step of scatter_fused=False, B1's LD "
            f"call over one of merge_fused=False)")
        del st_w, s_k, recs, o3, o5, o7, b7w

    # B5 and B7 at a compile-time width that no C1 row runs, on the warp
    # route: one step of scatter_fused=False and one of gather_fused=False
    # at dim_ld 16 from init_state, on the quantised X (Y on a quarter grid)
    # and on the real X, their launches counted under the route of the
    # width and each B5/B7 call held as above
    for d_w, route_w in ((16, "warp"),):
        cfg_ww = dataclasses.replace(cfg, dim_ld=d_w)
        check(edges_route(d_w) == route_w,
              f"B5/B7 at d = {d_w}: {edges_route(d_w)}, not {route_w}")
        for x_, quantised in ((Xq, True), (X, False)):
            st_ww = funcsne.init_state(x_, cfg_ww, seed=1, device=dev)
            if quantised:
                st_ww = st_ww._replace(Y=torch.round(st_ww.Y * 400.0) / 4.0)
            for flags, op, n_calls in ((dict(scatter_fused=False),
                                        "ne_forces_gather", 1),
                                       (dict(gather_fused=False), "ne_forces",
                                        3)):
                rec_w = Recorder(funcsne, d_w)
                kernels.reset_launches()
                funcsne.funcsne_step(dataclasses.replace(cfg_ww, **flags),
                                     st_ww, x_, hp, ops=rec_w.ops)
                key_w = edges_key(op, d_w)
                check(kernels.LAUNCHES[key_w] == n_calls,
                      f"d={d_w} {next(iter(flags))}=False: {key_w} launched "
                      f"{kernels.LAUNCHES[key_w]} times")
                for key, call in rec_w.calls.items():
                    if call[0] in EDGE_OPS:
                        held(f"{key} d={d_w}", *call, quantised)
                del rec_w
            del st_ww
            torch.cuda.empty_cache()
        log(f"[j] B5 and B7 at dim_ld {d_w}: the {route_w} route, one step of "
            f"scatter_fused=False and of gather_fused=False, held on "
            f"quantised and real inputs")

    # B5's and B7's routes against their warp route at shapes no path
    # gives them, on random inputs: each width of the rounds and staged
    # routes; B = 1 and an odd B (in pair mode the last warp's second row
    # lies past the end); one to four segments, two chunks at 48 edges, two
    # rows a warp at one segment of 7 or 16 edges; ids past both ends;
    # neighbour rows on 16 bytes and off them (at 8 and 32 those take the
    # warp route).  Each call: one launch of its route and nothing else,
    # outputs bit for bit the warp route's (int32 views), within
    # TOL_FORCE_REL of the plain version's
    sweep_b5 = (
        ((("attraction", 32), ("repulsion", 16), ("repulsion", 16)),
         (True, True, False)),
        ((("repulsion", 16),), (True,)),
        ((("attraction", 7),), (True,)),
        ((("attraction", 48), ("repulsion", 5), ("repulsion", 16),
          ("repulsion", 3)), (True, False, True, True)))
    sweep_fns = {"ne_forces": (ne_forces, ne_forces_ref),
                 "ne_forces_gather": (ne_forces_gather, ne_forces_gather_ref)}
    gen_s = torch.Generator(device=dev).manual_seed(23)
    n_s, alpha_s = 5000, torch.tensor(0.9, device=dev)
    n_sweep, sweep_routes = 0, set()

    def rows_s(*shape):
        """Random float32 (``shape``), on 16 bytes and 4 bytes past them."""
        flat_ = torch.randn(math.prod(shape) + 1, generator=gen_s,
                            device=dev)
        return flat_[:-1].view(shape), flat_[1:].view(shape)

    def coef_s(b_, k_):
        c_ = torch.rand((b_, k_), generator=gen_s, device=dev)
        return torch.where(c_ < 0.1, torch.zeros_like(c_), c_)

    for d_s in (1, 2, 3, 4, 8, 32):
        for b_s in (1, 3001):
            calls_s = []
            x_s = rows_s(n_s, d_s)
            qid_s = torch.randint(-2, n_s + 2, (b_s,), generator=gen_s,
                                  device=dev, dtype=torch.int32)
            for segs, emit in sweep_b5:
                k_s = sum(size for _, size in segs)
                nbr_s = torch.randint(-3, n_s + 3, (b_s, k_s), generator=gen_s,
                                      device=dev, dtype=torch.int32)
                c_s = coef_s(b_s, k_s)
                for x_a in x_s:
                    calls_s.append(("ne_forces_gather", x_a,
                                    (x_a, qid_s, nbr_s, c_s, alpha_s),
                                    dict(segments=segs, emit_edges=emit)))
            for k_s, mode in ((7, "attraction"), (16, "repulsion"),
                              (32, "attraction"), (48, "repulsion")):
                y_s, c_s = rows_s(b_s, d_s)[0], coef_s(b_s, k_s)
                for nb in rows_s(b_s, k_s, d_s):
                    calls_s.append(("ne_forces", nb, (y_s, nb, c_s, alpha_s),
                                    dict(mode=mode)))
            for op, src_s, args, kw in calls_s:
                fn, ref = sweep_fns[op]
                route = edges_route(d_s, src_s.data_ptr() % 16 == 0)
                key_s = op if route == "warp" else f"{op}_{route}"
                sweep_routes.add(key_s)
                label = (f"[j] sweep {op} d={d_s} B={b_s} "
                         f"{kw.get('segments', kw.get('mode'))} at "
                         f"{src_s.data_ptr() % 16}")
                before = dict(kernels.LAUNCHES)
                got = flat(fn(*args, **kw))
                moved = {k_: v_ - before[k_] for k_, v_ in
                         kernels.LAUNCHES.items() if v_ != before[k_]}
                check(moved == {key_s: 1},
                      f"{label}: launched {moved}, one launch of {key_s} "
                      "expected")
                with warp_route():
                    warp = flat(fn(*args, **kw))
                want = flat(ref(*args, **kw))
                for g, w, r in zip(got, warp, want):
                    if g is None or w is None:
                        check(g is None and w is None and r is None,
                              f"{label}: outputs emitted differ")
                        continue
                    check(torch.equal(g.view(torch.int32),
                                      w.view(torch.int32)),
                          f"{label}: not bit for bit the warp route's")
                    check(max_err(g, r) <= TOL_FORCE_REL *
                          max(float(r.abs().max()), 1e-30),
                          f"{label}: error {max_err(g, r)} against the plain "
                          "version")
                n_sweep += 1
    check(sweep_routes >= {f"{op}_{r}" for op in EDGE_OPS
                           for r in ("rounds", "staged")},
          f"the sweep reached {sorted(sweep_routes)}")
    log(f"[j] B5/B7 sweep: {n_sweep} calls (widths 1-4, 8, 32; B 1 and "
        f"3001; rows on and off 16 bytes), routes {sorted(sweep_routes)}, "
        "each bit for bit its warp route and within TOL_FORCE_REL of the "
        "plain version")
    del calls_s, x_s, got, warp, want
    torch.cuda.empty_cache()

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
        key_k = merge_key(op, DIM, "hd", cfg_k.k_hd, c_k)
        count = kernels.LAUNCHES[key_k]
        call = recr.calls[f"{op}_hd"]
        err = held(f"{op} K=128 C={c_k}", *call, False)
        name = f"{key_k}_K128_C{c_k}"
        (b2_entry if op == "knn_merge_cand" else b4_entry)(
            name, call, err, count, "[j]", graphed=True)
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

    # ---- (k) the secondary algorithms and the session controls -----------
    log(f"[k] starts {time.perf_counter() - t_start:.1f}s into the script")
    t_k = time.perf_counter()
    ns_cfg = baselines.NSConfig()
    key7 = edges_key("ne_forces", 2)

    # ns-70k: negative sampling on X.  B7 at both of its shapes and the
    # segment sum, recorded from iteration 0 on a quantised copy of the
    # start (edges exact) and on the start itself
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob, ns0 = baselines.ns_init(X, ns_cfg, dim_ld=2, hparams=hp, seed=0)
    torch.cuda.synchronize()
    t_ns_init = time.perf_counter() - t0
    neg0 = baselines.ns_negatives(prob, 0, ns_cfg.n_negatives)
    hp_ns = funcsne.default_schedule(0, NS_ITERS, hp)
    ns_q = ns0._replace(Y=torch.round(ns0.Y * (256.0 / float(
        ns0.Y.abs().max()))) / 4.0)
    recq, recr = Recorder(funcsne), Recorder(funcsne)
    baselines.ns_step(ns_cfg, prob, ns_q, neg0, hp_ns, 0, ops=recq.ops)
    baselines.ns_step(ns_cfg, prob, ns0, neg0, hp_ns, 0, ops=recr.ops)
    check(set(recr.calls) == {"ne_forces_0", "ne_forces_1", "segment_sum"},
          f"NS iteration calls {set(recr.calls)}")
    for key, call in recq.calls.items():
        held(f"NS {key}", *call, True)
    ns_err = {key: held(f"NS {key}", *call, False)
              for key, call in recr.calls.items()}
    s_k = baselines.ns_step(ns_cfg, prob, ns0, neg0, hp_ns, 0,
                            ops=funcsne.KERNELS)
    s_p = baselines.ns_step(ns_cfg, prob, ns0, neg0, hp_ns, 0,
                            ops=funcsne.PLAIN)
    for name in ("Y", "vel", "zhat"):
        a, b = getattr(s_k, name), getattr(s_p, name)
        check(max_err(a, b) <= TOL_STEP_REL * float(b.abs().max()),
              f"NS iteration {name}: err {max_err(a, b)}")
    check(float((s_k.gains != s_p.gains).float().mean()) < 1e-3,
          "NS iteration gains differ on more than 0.1% of entries")
    log(f"[k] ns-70k: B7 (attraction K {ns_cfg.k_hd}, repulsion K "
        f"{ns_cfg.n_negatives}) and the segment sum against their plain "
        f"versions (edges exact on the quantised start, the segment sum bit "
        f"for bit the CPU's); one iteration kernels vs plain: Y/vel/zhat "
        f"within {TOL_STEP_REL}")
    del s_k, s_p, ns_q, recq
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Y_ns = baselines.negative_sampling_embed(X, cfg=ns_cfg, dim_ld=2,
                                             n_iter=NS_ITERS, hparams=hp,
                                             seed=0, device=dev)
    torch.cuda.synchronize()
    t_ns = time.perf_counter() - t0
    launches_ns = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
    check(launches_ns == {key7: 2 * NS_ITERS, "segment_sum": NS_ITERS},
          f"ns-70k launched {launches_ns}")
    check(bool(torch.isfinite(Y_ns).all()), "ns-70k: Y not finite")
    auc_ns = float(embedding_quality(X[sub], Y_ns[sub]))
    its_ns = NS_ITERS / (t_ns - t_ns_init)
    log(f"[k] ns-70k: negative_sampling_embed(n_iter={NS_ITERS}) in "
        f"{t_ns:.2f}s (phase 1, exact KNN and perplexity, {t_ns_init:.2f}s "
        f"alone): {its_ns:.1f} iterations/s; launches {launches_ns}; Y "
        f"finite; R_NX AUC on {AUC_ROWS} rows {auc_ns:.4f} (main path "
        f"{auc:.4f})")
    for i, label in ((0, f"attraction_k{ns_cfg.k_hd}"),
                     (1, f"repulsion_k{ns_cfg.n_negatives}")):
        _, a7, kw7 = recr.calls[f"ne_forces_{i}"]
        o7 = ne_forces_ref(*a7, **kw7)
        entry(f"{key7}_ns_{label}", "src/repro_torch/csrc/ne_forces.cu",
              "src/repro/kernels/ne_forces/kernel.py:70",
              lambda: ne_forces(*a7, **kw7), lambda: ne_forces_ref(*a7, **kw7),
              50, nbytes(*a7, *o7), (12.0 + 4.0 * 2) * a7[2].numel(),
              ns_err[f"ne_forces_{i}"], launches_ns[key7] // 2, tag="[k]",
              graphed=True)
    _, (ix, vx, nx), _ = recr.calls["segment_sum"]
    out_s = torch.empty((nx, vx.shape[1]), device=dev)
    entry("segment_sum_ns", "src/repro_torch/csrc/segment_sum.cu",
          "src/repro/core/baselines.py:137",
          lambda: segment_sum(ix, vx, nx), lambda: segment_sum_ref(ix, vx, nx),
          20, nbytes(ix, vx, out_s), 1.0 * vx.numel(), ns_err["segment_sum"],
          launches_ns["segment_sum"],
          library=lambda: torch.zeros_like(out_s).index_add_(0, ix, vx),
          tag="[k]", graphed=True)
    log(f"    (B7's rows: one launch of each shape an iteration, "
        f"{launches_ns[key7]} in all; the segment sum over {ix.shape[0]} "
        f"rows of {vx.shape[1]} floats, {nx} sums)")
    del prob, ns0, recr, Y_ns, ix, vx, out_s, o7

    # tsne-5k: exact t-SNE on (d)'s subsample; its analytic gradient
    # against torch.autograd's of kl_loss
    Xs = X[sub]
    P = baselines.exact_p_matrix(Xs, 30.0)
    one = torch.tensor(1.0, device=dev)
    Yg = threefry.normal(threefry.prng_key(1), (AUC_ROWS, 2), device=dev)
    g_an = baselines.exact_tsne_grad(Yg, P, one)
    y_g = Yg.clone().requires_grad_(True)
    g_ad = torch.autograd.grad(ld_kernels.kl_loss(P, y_g, one), y_g)[0]
    g_rel = max_err(g_an, g_ad) / float(g_ad.abs().max())
    check(g_rel <= TOL_GRAD_REL, f"tsne-5k: gradient error {g_rel}")
    Y0 = threefry.normal(threefry.prng_key(0), (AUC_ROWS, 2), device=dev) \
        * 1e-2
    kl0 = float(ld_kernels.kl_loss(P, Y0, one))
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Y_ts = baselines.exact_tsne(P=P, n_iter=TSNE_ITERS, seed=0, device=dev)
    torch.cuda.synchronize()
    t_ts = time.perf_counter() - t0
    check(not any(kernels.LAUNCHES.values()), "tsne-5k launched a kernel")
    check(bool(torch.isfinite(Y_ts).all()), "tsne-5k: Y not finite")
    kl1 = float(ld_kernels.kl_loss(P, Y_ts, one))
    check(kl1 < kl0, f"tsne-5k: KL {kl1} not below its start {kl0}")
    auc_ts = float(embedding_quality(Xs, Y_ts))
    log(f"[k] tsne-5k: exact_tsne_grad against autograd of kl_loss, max "
        f"error {g_rel:.2e} of max|g| (tolerance {TOL_GRAD_REL}); "
        f"{TSNE_ITERS} iterations in {t_ts:.2f}s = "
        f"{TSNE_ITERS / t_ts:.1f} iterations/s (dense products and "
        f"elementwise ops, no kernel of the port); KL {kl0:.4f} -> "
        f"{kl1:.4f}; R_NX AUC {auc_ts:.4f}")
    del P, Yg, g_an, g_ad, y_g, Y_ts

    # hierarchy-70k: the alpha sweep at dim_ld 4 on X, DBSCAN timed per
    # level; then DBSCAN on the card against the CPU on a quantised
    # subsample of the last snapshot
    db_ms, snaps_h = [], []

    def timed_dbscan(Y, eps, min_pts):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lab = dbscan_mod.dbscan(Y, eps, min_pts)
        torch.cuda.synchronize()
        db_ms.append((time.perf_counter() - t) * 1e3)
        snaps_h.append(Y)
        return lab
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = hierarchy.extract_hierarchy(
        X, HIER_ALPHAS, warmup_iters=HIER_ITERS, iters_per_level=HIER_ITERS,
        hparams=hp, dbscan_fn=timed_dbscan, device=dev)
    torch.cuda.synchronize()
    t_h = time.perf_counter() - t0
    launches_h = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
    cfg_h = funcsne.FuncSNEConfig(n_points=N, dim_hd=DIM, dim_ld=4)
    want_h = {gather_key(DIM), gather_key(4),
              merge_key("knn_merge_cand", DIM, "hd", cfg_h.k_hd,
                        c_hd_of(cfg_h)),
              merge_key("knn_merge_cand", 4, "ld", cfg_h.k_ld, c_ld),
              "ne_forces_scatter"}
    check(set(launches_h) == want_h, f"hierarchy-70k launched {launches_h}")
    steps_h = HIER_ITERS * (1 + len(HIER_ALPHAS))
    check(launches_h["ne_forces_scatter"] == steps_h,
          f"hierarchy-70k: B3 {launches_h['ne_forces_scatter']} launches")
    check(all(lv.n_clusters > 0 for lv in graph.levels),
          "hierarchy-70k: a level without clusters")
    check(all(bool(torch.isfinite(y_).all()) for y_ in snaps_h),
          "hierarchy-70k: a snapshot not finite")
    log(f"[k] hierarchy-70k: extract_hierarchy(alphas={HIER_ALPHAS}, "
        f"{HIER_ITERS} warmup + {HIER_ITERS} a level, dim_ld 4) in "
        f"{t_h:.2f}s ({steps_h} steps); launches {launches_h}; clusters per "
        f"level {[lv.n_clusters for lv in graph.levels]}, noise "
        f"{[int((lv.labels < 0).sum()) for lv in graph.levels]}, "
        f"{len(graph.edges)} edges; DBSCAN "
        + ", ".join(f"{ms:.0f} ms" for ms in db_ms) + " a level")
    # a quarter grid with |y| <= 256 keeps every squared distance exact in
    # float32; scaled by the 99th percentile of |y|, so that a few far
    # rows do not fold the rest into a few cells, and clamped
    y_last = snaps_h[-1][sub]
    q99 = float(torch.quantile(y_last.abs().flatten(), 0.99))
    y_last = torch.round((y_last * (1024.0 / q99)).clamp(-1024.0, 1024.0)) \
        / 4.0
    eps_q = hierarchy.select_eps(y_last.cpu().numpy(), 0.02)
    lab_card = dbscan_mod.dbscan(y_last, eps_q, 5)
    lab_cpu = dbscan_mod.dbscan(y_last.cpu(), eps_q, 5)
    check(torch.equal(lab_card.cpu(), lab_cpu),
          "hierarchy-70k: DBSCAN on the card differs from the CPU's")
    _, k_q = dbscan_mod.relabel_compact(lab_card)
    check(k_q > 1, f"hierarchy-70k: the quantised subsample has {k_q} "
          "cluster(s), too few for the comparison to test anything")
    log(f"    DBSCAN of the last snapshot's {AUC_ROWS} subsample rows on a "
        f"quarter grid (eps {eps_q:.4g}, {k_q} clusters, "
        f"{int((lab_card < 0).sum())} noise): the card's labels equal the "
        f"CPU's bit for bit")
    del graph, snaps_h, y_last, lab_card, lab_cpu

    # session-70k: a third of the rows (every third) active, three waves of
    # fit(state=...) with add_points between them, then remove_points
    hold = lambda it, n_iter, h: h      # noqa: E731
    rows_all = torch.arange(N, device=dev)
    labels_all = torch.from_numpy(y_np).to(dev)

    def active_recall(s):
        rows_a = torch.nonzero(s.active)[:, 0]
        rows_a = rows_a[::max(1, rows_a.shape[0] // RECALL_ROWS)]
        true_a, _ = knn.exact_knn(X, cfg.k_hd, active=s.active, rows=rows_a)
        est = s.hd_idx[rows_a].long()
        hit = (est[:, :, None] == true_a.long()[:, None, :]).any(-1)
        return float(hit.float().mean())

    def audit_counts(s):
        return {f: int(v) for f, v in
                funcsne.audit_state(s, cfg, X)._asdict().items()}
    clean = {f: 0 for f in funcsne.AuditResult._fields}
    kernels.reset_launches()
    st_s = funcsne.init_state(X, cfg, seed=0, active=rows_all % 3 == 0,
                              perplexity=hp.perplexity, device=dev)
    st_w0, waves = None, []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_s, _ = funcsne.fit(X, cfg=cfg, n_iter=SESSION_ITERS, chunk_size=CHUNK,
                              hparams=hp, schedule=hold, state=st_s,
                              validate=w == 0, device=dev)
        torch.cuda.synchronize()
        sps_s = SESSION_ITERS / (time.perf_counter() - t0)
        check(audit_counts(st_s) == clean,
              f"session wave {w}: audit {audit_counts(st_s)}")
        check(bool(torch.isfinite(st_s.Y).all()), f"wave {w}: Y not finite")
        waves.append((int(st_s.active.sum()), sps_s, active_recall(st_s)))
        if w == 0:
            st_w0 = st_s
        if w < 2:
            st_s = funcsne.add_points(
                st_s, torch.nonzero(rows_all % 3 == w + 1)[:, 0],
                threefry.prng_key(w))
    launches_s = {k_: v_ for k_, v_ in kernels.LAUNCHES.items() if v_}
    check(set(launches_s) == main_kernels,
          f"session-70k launched {launches_s}")
    cls0 = torch.nonzero(labels_all == 0)[:, 0]
    st_s = funcsne.remove_points(st_s, cls0)
    y_rm = st_s.Y[cls0].clone()
    st_s, _ = funcsne.fit(X, cfg=cfg, n_iter=SESSION_REMOVE_ITERS,
                          chunk_size=CHUNK, hparams=hp, schedule=hold,
                          state=st_s, validate=False, device=dev)
    check(torch.equal(st_s.Y[cls0], y_rm), "removed rows moved")
    check(audit_counts(st_s) == clean, "session: audit after the removal")
    check(bool(torch.isfinite(st_s.Y).all()), "session: Y not finite")
    rec_rm = active_recall(st_s)
    for w, (n_act, sps_s, rec_w) in enumerate(waves):
        log(f"[k] session-70k wave {w}: {n_act} active rows, "
            f"{SESSION_ITERS} steps at {sps_s:.1f} steps/s, recall@"
            f"{cfg.k_hd} of active rows against exact_knn(active=) "
            f"{rec_w:.4f}, audit all zero")
    log(f"    after remove_points of class 0 ({cls0.shape[0]} rows) and "
        f"{SESSION_REMOVE_ITERS} steps: {int(st_s.active.sum())} active, the "
        f"removed rows' Y unchanged, recall {rec_rm:.4f}, audit all zero; "
        f"launches over the waves {launches_s}")
    # wave 0's state (two thirds of the rows inactive): one step on a
    # quantised copy through the kernels against through the plain versions
    stq_s = forced(st_w0._replace(Y=torch.round(st_w0.Y * (256.0 / float(
        st_w0.Y.abs().max()))) / 4.0))
    recq = Recorder(funcsne)
    funcsne.funcsne_step(cfg, stq_s, Xq, hp, ops=recq.ops)
    for key, call in recq.calls.items():
        held(f"session {key}", *call, True)
    st_k = funcsne.funcsne_step(cfg, stq_s, Xq, hp, ops=funcsne.KERNELS)
    st_p = funcsne.funcsne_step(cfg, stq_s, Xq, hp, ops=funcsne.PLAIN)
    for name in ("hd_idx", "hd_d", "ld_idx", "ld_d", "new_flag", "active",
                 "step", "ema_new_frac"):
        check(torch.equal(getattr(st_k, name), getattr(st_p, name)),
              f"session step {name} differs")
    for name in ("Y", "vel", "zhat"):
        a, b = getattr(st_k, name), getattr(st_p, name)
        check(max_err(a, b) <= TOL_STEP_REL * float(b.abs().max()),
              f"session step {name}: err {max_err(a, b)}")
    check(float((st_k.gains != st_p.gains).float().mean()) < 1e-3,
          "session step gains differ on more than 0.1% of entries")
    # planted faults on a copy: one id out of range, one duplicate, one NaN
    act_rows = torch.nonzero(st_s.active)[:, 0]
    r1, r2, r3 = (int(act_rows[i]) for i in (0, 1, 2))
    bad_hd, bad_ld, bad_y = (st_s.hd_idx.clone(), st_s.ld_idx.clone(),
                             st_s.Y.clone())
    bad_hd[r1, 0] = N + 5
    bad_ld[r2, 0] = bad_ld[r2, 1]
    bad_y[r3, 0] = float("nan")
    planted = audit_counts(st_s._replace(hd_idx=bad_hd, ld_idx=bad_ld,
                                         Y=bad_y))
    check(planted == dict(clean, hd_oob=1, ld_dup=1, y_nonfinite=1),
          f"session: audit of the planted faults {planted}")
    n_off = int((~st_w0.active).sum())
    log(f"[k] session-70k: one step from wave 0's state ({n_off} inactive "
        f"rows) kernels vs plain on quantised inputs: "
        f"ids/distances/flags exact, Y/vel/zhat within {TOL_STEP_REL}; each "
        f"kernel held; audit of a copy with planted faults {planted}")
    del st_s, st_w0, stq_s, st_k, st_p, recq, bad_hd, bad_ld, bad_y
    log(f"[k] phase (k) took {time.perf_counter() - t_k:.1f}s")

    # ---- (l) resilience and recovery ----------------------------------------
    log(f"[l] starts {time.perf_counter() - t_start:.1f}s into the script")
    resilience_phase(X, y_np, cfg, hp, st, ITERS / t_run, recall,
                     main_kernels, hd_key, ld_key, card)

    # ---- (m) the distributed step on the card -------------------------------
    log(f"[m] starts {time.perf_counter() - t_start:.1f}s into the script")
    from repro_torch.launch import mesh as mesh_lib
    t_m = time.perf_counter()
    torch.cuda.empty_cache()
    # (m1), (m3), (m4): gloo ranks on the one card, then one NCCL rank
    rows_np, sub_np = rows.cpu().numpy(), sub.cpu().numpy()
    fit_job = {"kind": "fit", "timed": False, "fault": None}
    jobs_g = [{"kind": "collectives"},
              dict(fit_job, model=1, iters=M_ITERS[(2, 1)]),
              dict(fit_job, model=1, iters=M_ITERS[(2, 1)], timed=True),
              dict(fit_job, model=2, iters=M_ITERS[(1, 2)], timed=True),
              dict(fit_job, model=1, iters=M_FAULT_ITERS, fault=M_FAULT_AT)]
    jobs_n = [{"kind": "collectives"},
              dict(fit_job, model=1, iters=M_ITERS[(1, 1)], timed=True)]
    results = {}
    for world, jobs in ((2, jobs_g), (1, jobs_n)):
        backend = mesh_lib.pick_backend(dev, world)
        t0 = time.perf_counter()
        results[world] = mesh_lib.run_ranks(
            mesh_rank, world, (jobs, N, DIM, rows_np, sub_np, CHUNK),
            device=dev, backend=backend, timeout=M_TIMEOUT)
        log(f"[m] {world} rank(s) on {torch.cuda.device_count()} card(s) "
            f"under {backend} (rule: NCCL when every rank has a card of its "
            f"own, else gloo): {len(jobs)} jobs in "
            f"{time.perf_counter() - t0:.1f}s")
    for world in (2, 1):
        for rank, out_r in enumerate(results[world]):
            backend, failed = out_r[0]
            check(not failed, f"(m1) {world} ranks {backend}, rank {rank}: "
                  f"{failed}")
        log(f"[m1] collectives on the card, {world} rank(s) under "
            f"{results[world][0][0][0]}: all_gather int32, bf16 sum, min, "
            "max exact on CUDA tensors")
    expected = {b1_key["hd"], b1_key["ld"], ld_key["knn_merge_cand"],
                "ne_forces_scatter"}
    runs = {"(2,1) run 1": (2, 1), "(2,1) run 2": (2, 2),
            "(1,2)": (2, 3), "(1,1)": (1, 1)}
    counts, m_quality = {}, {}
    for label, (world, j) in runs.items():
        per_rank = [out_r[j] for out_r in results[world]]
        iters = (jobs_g if world == 2 else jobs_n)[j]["iters"]
        for rank, r_ in enumerate(per_rank):
            la = r_["launches"]
            check(set(la) == expected, f"{label} rank {rank}: launched {la}")
            check(la["ne_forces_scatter"] == iters
                  and la[ld_key["knn_merge_cand"]] == iters
                  and la[b1_key["ld"]] == 1 and la[b1_key["hd"]] > 1,
                  f"{label} rank {rank}: launches {la}")
            check(r_["finite"] and r_["step"] == iters,
                  f"{label} rank {rank}: Y finite {r_['finite']}, step "
                  f"{r_['step']}")
            check(r_["hashes"] == per_rank[0]["hashes"],
                  f"{label}: rank {rank}'s replica differs from rank 0's")
        counts[label] = per_rank[-1]["launches"]
        r0 = per_rank[0]
        rec_m = float((r0["hd_rows"].to(dev)[:, :, None].long()
                       == true_idx.long()[:, None, :]).any(-1).float().mean())
        auc_m = float(embedding_quality(X[sub], r0["y_sub"].to(dev)))
        m_quality[label] = (rec_m, auc_m)
        if iters == ITERS:
            check(rec_m > RECALL_MIN, f"{label}: recall {rec_m}")
        coll = "; ".join(
            f"{tag} {b / iters / 1e6:.4f} MB"
            + (f" {ms / iters:.3f} ms" if ms else "") + f" ({c} calls)"
            for tag, (c, b, ms) in sorted(r0["collectives"].items()))
        log(f"[m3] mnist-70k {label} under {r0['backend']}: {iters} steps at "
            f"{r0['sps']:.1f} steps/s a rank"
            + (" (ranks time-share one card: not a multi-GPU speed)"
               if world > 1 else "")
            + f"; recall@{cfg.k_hd} {rec_m:.4f} (phase (d) "
            f"{rec1:.4f}), AUC {auc_m:.4f} (phase (d) {auc:.4f}); launches "
            f"per rank {counts[label]}; replicas bit-identical across "
            f"{len(per_rank)} rank(s); per step on rank 0: "
            + (coll or "no collective (one rank)"))
    a_, b_ = results[2][0][1], results[2][0][2]
    check(a_["hashes"] == b_["hashes"], "(2,1): two runs differ")
    log("[m3] (2,1): the two runs' states bit-identical (hash of every field)")
    for rank, out_r in enumerate(results[2]):
        r_ = out_r[4]
        kinds = [e["kind"] for e in r_["events"]]
        check(kinds == ["rollback"] and r_["finite"]
              and r_["step"] == M_FAULT_ITERS
              and "finite_frac" in r_["events"][0]["reason"],
              f"(m4) rank {rank}: events {r_['events']}")
    log(f"[m4] NaNChunk(shard=1, field=vel) at step {M_FAULT_AT} of a (2,1) "
        f"run: the reduced probe tripped on both ranks "
        f"({results[2][0][4]['events'][0]['reason']}), one rollback, Y "
        f"finite after {M_FAULT_ITERS} steps")
    # (m2)'s rows take the launches of the runs that run each shape
    for row, run, key in m_rows:
        row["launches"] = counts[run][key]
    log(f"[m] phase (m) took {time.perf_counter() - t_m:.1f}s")

    # ---- (n) the elastic runtime across hosts -------------------------------
    log(f"[n] starts {time.perf_counter() - t_start:.1f}s into the script")
    elastic_phase(X, rows, sub, true_idx, rec1, auc,
                  m_quality["(2,1) run 1"], expected, card)

    # ---- (o) the LM serving path and A7's examples -------------------------
    log(f"[o] starts {time.perf_counter() - t_start:.1f}s into the script")
    out.extend(serve_phase("o"))

    # ---- (p) serving for MLA, Mamba2 and Zamba2 ----------------------------
    log(f"[p] starts {time.perf_counter() - t_start:.1f}s into the script")
    out.extend(serve_phase("p"))

    # ---- (q) LM training ---------------------------------------------------
    log(f"[q] starts {time.perf_counter() - t_start:.1f}s into the script")
    out.extend(serve_phase("q"))

    log(f"    total {time.perf_counter() - t_start:.1f}s")

    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
