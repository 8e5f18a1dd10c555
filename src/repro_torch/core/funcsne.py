"""FUnc-SNE's step, chunk runner, fit and distributed step (port of
``repro.core.funcsne``).

One ``funcsne_step`` does, in the JAX package's order:
  1. the gate: refine the HD lists with probability 0.05 + 0.95 E[N_new/N];
  2. HD refinement (``_hd_refine``): the candidate-fused merge kernel on X;
  3. the sigma refresh every ``sigma_refresh_every`` steps;
  4. LD refinement (``_ld_refine``): the same kernel on Y, current rows
     re-scored;
  5. forces (``_forces_update``): the scatter-fused force kernel, the Z
     estimate and the gains/momentum update.

Every setting of the JAX config runs on one device: the default fused path
(kernels B1-B3), ``gather_fused=False`` (B6 on pre-gathered rows, B7 per
force segment, a deterministic segment-sum symmetrisation),
``scatter_fused=False`` (B5, the same symmetrisation),
``merge_fused=False`` (B1 and the plain dedup/merge), reverse-edge
candidates (``c_hd_rev > 0``, the table rebuilt every
``rev_refresh`` steps) and ``cand_fused=False``, where the candidates,
negatives, gate and reverse-table fill come from threefry and the merge is
B4 on the precomputed candidate block.

With ``cand_fused=True`` every draw inside a step comes from the counter
hash keyed on the state's key words; with ``cand_fused=False`` from
``core.threefry``, which reproduces ``jax.random``.  Either way the port
and the JAX package draw the same candidates and negatives from the same
state, and ``init_state(seed=s)`` draws the JAX package's start for
``PRNGKey(s)``: the same lists and key, Y within ``normal``'s tolerance.

A session between chunks uses ``add_points``, ``remove_points``,
``rescale_embedding`` and ``audit_state``; ``fit`` drives the chunks, with
its ``callback``, ``early_stop`` and ``auto_rescale``, and under a
``ResiliencePolicy`` (``core.resilience``) rolls back tripped chunks,
checkpoints (``repro_torch.checkpoint``) and resumes.

PyTorch runs eagerly, so the chunk runner (``make_chunked_step``) is a
Python loop over steps; the gate's branch and the reverse-table cadence are
one host sync per step.  On the threefry path that sync also fetches the
key words, so the scalar key chain (``fold_in``, ``split``, the gate's
``bernoulli``) runs on the host and only the (n, c) draws on the device.

Distribution (``make_distributed_step``): one process a rank on a
``repro_torch.launch.mesh.Grid``, the state replicated on every rank.
Each rank owns a contiguous row slice per phase (the HD refinement: the
``points`` axes; the sigma refresh, LD refinement and forces: points x
feat), and the slices are reassembled with tiled all-gathers and one
force all-reduce.  X is split by columns over the ``feat`` axis and the
squared HD distances are summed over it.  ``ctx=AxisCtx()`` (no axes) is
the single-device program, so both paths share this code.  The wire
formats are the reference's: the force sum crosses in bf16 after a
float32 local accumulation (H10a), ``ld_d`` is never gathered (H10b: a
zeros placeholder, re-derived at the next refinement), and ``hd_d``
crosses in bf16 (H11).  Every rank reads its own replica for the host
decisions (the gate, the sigma and reverse-table cadences); the replicas
are identical, so the decisions agree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import warnings
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.checkpoint import Checkpointer, cfg_compat
from repro_torch.core import affinities
from repro_torch.core import knn
from repro_torch.core import threefry
from repro_torch.core.knn import SENTINEL
from repro_torch.core.resilience import EmbeddingDiverged
from repro_torch.kernels import fallback
from repro_torch.kernels.knn_merge.ops import (MAX_C, MAX_K, knn_merge,
                                               knn_merge_cand)
from repro_torch.kernels.knn_merge.ref import knn_merge_cand_ref, knn_merge_ref
from repro_torch.kernels.ne_forces.ops import (ne_forces, ne_forces_gather,
                                               ne_forces_scatter)
from repro_torch.kernels.ne_forces.ref import (ne_forces_gather_ref,
                                               ne_forces_ref,
                                               ne_forces_scatter_ref)
from repro_torch.kernels.pairwise_sqdist.ops import (pairwise_sqdist,
                                                     pairwise_sqdist_gather)
from repro_torch.kernels.pairwise_sqdist.ref import (
    pairwise_sqdist_gather_ref, pairwise_sqdist_ref)
from repro_torch.kernels.segment_sum.ops import segment_sum
from repro_torch.kernels.segment_sum.ref import segment_sum_ref
from repro_torch.runtime import faults
from repro_torch.runtime.straggler import StepTimeMonitor


# --------------------------------------------------------------------------
# Configuration and state


@dataclasses.dataclass(frozen=True)
class FuncSNEConfig:
    """Static configuration (fields and defaults of the JAX config)."""
    n_points: int
    dim_hd: int
    dim_ld: int = 2
    k_hd: int = 32
    k_ld: int = 16
    c_hd_non: int = 4             # HD neighbours-of-neighbours
    c_hd_ld: int = 2              # LD neighbours proposed cross-space
    c_hd_ld_non: int = 2          # LD neighbours-of-neighbours cross-space
    c_hd_rand: int = 2            # uniform probes
    c_hd_rev: int = 0             # reverse edges
    c_ld_non: int = 4
    c_ld_hd: int = 2
    c_ld_rand: int = 2
    n_negatives: int = 16
    sigma_refresh_every: int = 10
    min_refresh_prob: float = 0.05
    ema_decay: float = 0.9
    z_ema_decay: float = 0.9
    gather_fused: bool = True
    scatter_fused: bool = True
    merge_fused: bool = True
    cand_fused: bool = True
    rev_refresh: int = 10         # steps between reverse-table rebuilds


class HParams(NamedTuple):
    """Hyperparameters as 0-dim float32 tensors on the state's device."""
    alpha: Any
    perplexity: Any
    lr: Any
    momentum: Any
    attraction: Any
    repulsion: Any
    exaggeration: Any


class FuncSNEState(NamedTuple):
    Y: Any          # (N, d_ld) f32
    vel: Any        # (N, d_ld) f32
    gains: Any      # (N, d_ld) f32
    hd_idx: Any     # (N, k_hd) int32, sorted by hd_d ascending
    hd_d: Any       # (N, k_hd) f32 squared HD distances
    ld_idx: Any     # (N, k_ld) int32
    ld_d: Any       # (N, k_ld) f32 squared LD distances
    beta: Any       # (N,) f32 1/(2 sigma_i^2)
    new_flag: Any   # (N,) bool: new HD neighbour since the last refresh
    active: Any     # (N,) bool: dynamic-dataset membership
    ema_new_frac: Any   # () f32
    zhat: Any       # () f32 EMA'd Z estimator
    step: Any       # () int32
    rng: Any        # (2,) int64: the uint32 words of the JAX key
    rev_idx: Any    # (N, c_hd_rev) int32 cached reverse edges
    rev_step: Any   # () int32 step of the last reverse-table rebuild


class Ops(NamedTuple):
    """The kernel entry points a step calls."""
    pairwise_sqdist_gather: Callable    # B1
    knn_merge_cand: Callable            # B2
    ne_forces_scatter: Callable         # B3
    knn_merge: Callable                 # B4
    ne_forces_gather: Callable          # B5
    pairwise_sqdist: Callable           # B6
    ne_forces: Callable                 # B7
    segment_sum: Callable               # the unfused paths' symmetrisation


# the kernel wrappers (the plain version on CPU tensors, the CUDA kernel on
# CUDA tensors) -- and the plain versions alone, which run on either
# device and are what the kernels are compared with on the card
KERNELS = Ops(pairwise_sqdist_gather, knn_merge_cand, ne_forces_scatter,
              knn_merge, ne_forces_gather, pairwise_sqdist, ne_forces,
              segment_sum)
PLAIN = Ops(pairwise_sqdist_gather_ref, knn_merge_cand_ref,
            ne_forces_scatter_ref, knn_merge_ref, ne_forces_gather_ref,
            pairwise_sqdist_ref, ne_forces_ref, segment_sum_ref)

# counter-RNG stream tags: per-step salts are hash3(base, step, TAG)
_TAG_GATE, _TAG_HD, _TAG_LD, _TAG_NEG, _TAG_REV = 1, 2, 3, 4, 5


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must exist when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_hparams(n: int, *, alpha=1.0, perplexity=30.0, lr=None,
                    momentum=0.8, attraction=1.0, repulsion=1.0,
                    exaggeration=1.0, device="cuda") -> HParams:
    if lr is None:
        lr = max(50.0, n / 12.0)   # openTSNE-style default
    dev = resolve_device(device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    return HParams(f32(alpha), f32(perplexity), f32(lr), f32(momentum),
                   f32(attraction), f32(repulsion), f32(exaggeration))


class AxisCtx(NamedTuple):
    """Grid axis names; all None -> single-device execution.  ``grid`` is
    the :class:`~repro_torch.launch.mesh.Grid` the names refer to."""
    points: Optional[tuple] = None    # axes sharding KNN-phase rows
    feat: Optional[str] = None        # axis sharding the HD feature dim
    grid: Any = None

    @property
    def all_rows(self) -> Optional[tuple]:
        if self.points is None:
            return None
        return self.points + ((self.feat,) if self.feat else ())


def _take(arr, idx):
    """Gather rows with SENTINEL-safe clipping."""
    return arr[idx.long().clamp(0, arr.shape[0] - 1)]


def _phase_rows(n: int, axes, ctx: AxisCtx):
    """(start, n_local) of this rank's contiguous row slice for a phase:
    ``n // shards`` rows, so rows past ``shards * (n // shards)`` belong to
    no rank's slice."""
    if axes is None:
        return 0, n
    n_loc = n // ctx.grid.axis_size(axes)
    return ctx.grid.axis_index(axes) * n_loc, n_loc


def _rows(t, start: int, n_loc: int):
    """Rows ``[start, start + n_loc)`` of ``t`` (``t`` itself when that is
    all of it)."""
    if start == 0 and n_loc == t.shape[0]:
        return t
    return t[start:start + n_loc]


def _slice_ids(start: int, n_loc: int, device):
    return start + torch.arange(n_loc, dtype=torch.int32, device=device)


def _gather_rows(local, full, axes, ctx: AxisCtx, tag: str):
    """Reassemble per-rank row slices of ``full``'s rows (a tiled all-gather
    along ``axes``, cast to ``full``'s dtype); rows past the slices keep
    ``full``'s values."""
    if axes is None:
        return local
    got = ctx.grid.all_gather(local, axes, tag=tag).to(full.dtype)
    if got.shape[0] == full.shape[0]:
        return got
    return torch.cat([got, full[got.shape[0]:]])


# --------------------------------------------------------------------------
# Phases


def _row_sqdist(cfg: FuncSNEConfig, X, ids, cand, ops: Ops,
                ctx: AxisCtx = AxisCtx()):
    """Squared HD distances rows -> candidates: B1 on indices, or with
    ``gather_fused=False`` B6 on the pre-gathered rows; on a grid each rank
    scores its column block of X and the partial sums add up over the
    feat axis."""
    if cfg.gather_fused:
        d = ops.pairwise_sqdist_gather(X, ids, cand)
    else:
        d = ops.pairwise_sqdist(X[ids.long()], _take(X, cand))
    if ctx.feat is not None:
        d = ctx.grid.all_reduce(d, ctx.feat, "sum", tag="cand_d")
    return d


def _rev_update(cfg: FuncSNEConfig, st: FuncSNEState, fill):
    """Rebuild the cached reverse-edge table from the current HD lists,
    padding with ``fill`` (n, c_hd_rev).

    The caller decides, from ``rev_step`` read on the host, that
    ``rev_refresh`` steps have passed since the last rebuild; the cadence
    counts from that rebuild because refinement itself runs behind the
    stochastic gate.
    """
    rev = knn.reverse_neighbors(st.hd_idx, cfg.n_points, cfg.c_hd_rev,
                                fill=fill)
    return st._replace(rev_idx=rev, rev_step=st.step.clone())


def _hd_refine(cfg: FuncSNEConfig, st: FuncSNEState, X, rng, ops: Ops,
               rev_due: bool = False, ctx: AxisCtx = AxisCtx()):
    """HD refinement; ``rng`` is the base salt (counter RNG) or the step's
    threefry key, and ``rev_due`` rebuilds the reverse table first.

    On a grid the rank refines its ``points`` row slice.  The in-kernel
    merge (B2) needs full distances, so with ``ctx.feat`` set (always, on
    a grid) the candidates are drawn on their own, scored by B1 on the
    rank's column block, summed over the feat axis and merged by
    ``knn.merge_knn``."""
    n = cfg.n_points
    start, n_loc = _phase_rows(n, ctx.points, ctx)
    ids = _slice_ids(start, n_loc, st.Y.device)
    dev = ids.device
    hd_l = _rows(st.hd_idx, start, n_loc)
    hd_d_l = _rows(st.hd_d, start, n_loc)
    ld_l = _rows(st.ld_idx, start, n_loc)
    use_kernel = cfg.merge_fused and cfg.gather_fused and ctx.feat is None
    if cfg.cand_fused:
        # counter draws keyed on global row ids: no fold by rank needed
        salt = knn.hash3(rng, st.step, _TAG_HD)
        if cfg.c_hd_rev and rev_due:
            st = _rev_update(cfg, st, knn.counter_fill(
                knn.hash3(rng, st.step, _TAG_REV), n, cfg.c_hd_rev))
        rev = _rows(st.rev_idx, start, n_loc) if cfg.c_hd_rev else None
        sources = (("two_hop", 0, 0, cfg.c_hd_non),
                   ("one_hop", 1, cfg.c_hd_ld),
                   ("two_hop", 1, 1, cfg.c_hd_ld_non),
                   ("uniform", cfg.c_hd_rand),
                   ("extra", cfg.c_hd_rev))
        firsts, seconds = (hd_l, ld_l), (st.hd_idx, st.ld_idx)
        if use_kernel:
            new_idx, new_d, improved = ops.knn_merge_cand(
                X, ids, hd_l, hd_d_l, salt=salt, sources=sources,
                first_tables=firsts, second_tables=seconds, extra=rev,
                active=st.active)
            return _hd_merged(cfg, st, new_idx, new_d, improved, ctx)
        cand = knn.counter_candidates(salt, ids, sources, firsts, seconds,
                                      n_total=n, extra=rev)
    else:
        rng0 = rng
        if ctx.points is not None:
            rng = threefry.fold_in(rng, ctx.grid.axis_index(ctx.points))
        r = threefry.split(rng, 5)
        parts = []
        if cfg.c_hd_non:
            parts.append(knn.sample_hops(r[0], hd_l, st.hd_idx, ids,
                                         cfg.c_hd_non))
        if cfg.c_hd_ld:
            parts.append(knn.sample_direct(r[1], ld_l, cfg.c_hd_ld))
        if cfg.c_hd_ld_non:
            parts.append(knn.sample_hops(r[2], ld_l, st.ld_idx, ids,
                                         cfg.c_hd_ld_non))
        if cfg.c_hd_rand:
            parts.append(knn.sample_uniform(r[3], n_loc, n, cfg.c_hd_rand,
                                            device=dev))
        if cfg.c_hd_rev:
            if rev_due:
                # the table is replicated, so its fill is the same on every
                # rank: on a grid it comes from the key before the fold
                fill_key = r[4] if ctx.points is None \
                    else threefry.split(rng0, 5)[4]
                st = _rev_update(cfg, st, knn.sample_uniform(
                    fill_key, n, n, cfg.c_hd_rev, device=dev))
            parts.append(_rows(st.rev_idx, start, n_loc))
        cand = torch.cat(parts, dim=1)
    cand_active = _take(st.active, cand)
    if use_kernel:
        new_idx, new_d, improved = ops.knn_merge(
            X, ids, hd_l, hd_d_l, cand, cand_active=cand_active)
    else:
        valid = knn.dedup_candidates(ids, hd_l, cand) & cand_active
        cand_d = _row_sqdist(cfg, X, ids, cand, ops, ctx)
        new_idx, new_d, improved = knn.merge_knn(hd_l, hd_d_l, cand,
                                                 cand_d, valid)
    return _hd_merged(cfg, st, new_idx, new_d, improved, ctx)


def _hd_merged(cfg: FuncSNEConfig, st: FuncSNEState, new_idx, new_d,
               improved, ctx: AxisCtx = AxisCtx()):
    """The HD merge's result into the state, with the E[N_new/N] EMA; on a
    grid the row slices are gathered first, ``hd_d`` in bf16 (H11)."""
    if ctx.points is not None:
        new_idx = _gather_rows(new_idx, st.hd_idx, ctx.points, ctx, "hd_idx")
        new_d = _gather_rows(new_d.to(torch.bfloat16), st.hd_d, ctx.points,
                             ctx, "hd_d")
        improved = _gather_rows(improved, torch.zeros_like(st.new_flag),
                                ctx.points, ctx, "improved")
    n_act = st.active.float().sum().clamp_min(1.0)
    frac = (improved & st.active).float().sum() / n_act
    ema = cfg.ema_decay * st.ema_new_frac + (1.0 - cfg.ema_decay) * frac
    return st._replace(hd_idx=new_idx, hd_d=new_d,
                       new_flag=st.new_flag | improved, ema_new_frac=ema)


def _sigma_refresh(cfg: FuncSNEConfig, st: FuncSNEState, hp: HParams,
                   ctx: AxisCtx = AxisCtx()):
    start, n_loc = _phase_rows(cfg.n_points, ctx.all_rows, ctx)
    hd_d_l = _rows(st.hd_d, start, n_loc)
    hd_i_l = _rows(st.hd_idx, start, n_loc)
    beta_l = _rows(st.beta, start, n_loc)
    valid = torch.isfinite(hd_d_l) & (hd_i_l != SENTINEL)
    valid &= _take(st.active, hd_i_l)
    solved = affinities.solve_beta(hd_d_l, hp.perplexity, valid=valid,
                                   beta0=beta_l, n_iter=24)
    beta_l = torch.where(_rows(st.new_flag, start, n_loc), solved, beta_l)
    return st._replace(
        beta=_gather_rows(beta_l, st.beta, ctx.all_rows, ctx, "beta"),
        new_flag=torch.zeros_like(st.new_flag))


def _ld_refine(cfg: FuncSNEConfig, st: FuncSNEState, rng, ops: Ops,
               ctx: AxisCtx = AxisCtx()):
    n = cfg.n_points
    start, n_loc = _phase_rows(n, ctx.all_rows, ctx)
    ids = _slice_ids(start, n_loc, st.Y.device)
    ld_l = _rows(st.ld_idx, start, n_loc)
    hd_l = _rows(st.hd_idx, start, n_loc)
    use_kernel = cfg.merge_fused and cfg.gather_fused
    cur_valid = (ld_l != SENTINEL) & _take(st.active, ld_l)
    if cfg.cand_fused:
        salt = knn.hash3(rng, st.step, _TAG_LD)
        sources = (("two_hop", 0, 0, cfg.c_ld_non),
                   ("one_hop", 1, cfg.c_ld_hd),
                   ("uniform", cfg.c_ld_rand))
        firsts, seconds = (ld_l, hd_l), (st.ld_idx,)
        if use_kernel:
            new_idx, new_d, _ = ops.knn_merge_cand(
                st.Y, ids, ld_l, None, salt=salt, sources=sources,
                first_tables=firsts, second_tables=seconds, active=st.active,
                cur_valid=cur_valid)
            return _ld_merged(st, new_idx, new_d, ctx)
        cand = knn.counter_candidates(salt, ids, sources, firsts, seconds,
                                      n_total=n)
    else:
        if ctx.all_rows is not None:
            rng = threefry.fold_in(rng, ctx.grid.axis_index(ctx.all_rows))
        r = threefry.split(rng, 3)
        parts = []
        if cfg.c_ld_non:
            parts.append(knn.sample_hops(r[0], ld_l, st.ld_idx, ids,
                                         cfg.c_ld_non))
        if cfg.c_ld_hd:
            # HD neighbours: stable LD candidates unaffected by the motion
            parts.append(knn.sample_direct(r[1], hd_l, cfg.c_ld_hd))
        if cfg.c_ld_rand:
            parts.append(knn.sample_uniform(r[2], n_loc, n, cfg.c_ld_rand,
                                            device=ids.device))
        cand = torch.cat(parts, dim=1)
    cand_active = _take(st.active, cand)
    if use_kernel:
        new_idx, new_d, _ = ops.knn_merge(st.Y, ids, ld_l, None, cand,
                                          cand_active=cand_active,
                                          cur_valid=cur_valid)
        return _ld_merged(st, new_idx, new_d, ctx)
    valid = knn.dedup_candidates(ids, ld_l, cand) & cand_active
    # re-score the current rows too: the embedding moved since the merge
    k = ld_l.shape[1]
    if cfg.gather_fused:
        both = ops.pairwise_sqdist_gather(st.Y, ids,
                                          torch.cat([ld_l, cand], dim=1))
        cur_d, cand_d = both[:, :k], both[:, k:]
    else:
        y_l = st.Y[ids.long()]
        cur_d = ((_take(st.Y, ld_l) - y_l[:, None, :]) ** 2).sum(-1)
        cand_d = ((_take(st.Y, cand) - y_l[:, None, :]) ** 2).sum(-1)
    cur_d = torch.where(cur_valid, cur_d, torch.inf)
    new_idx, new_d, _ = knn.merge_knn(ld_l, cur_d, cand, cand_d, valid)
    return _ld_merged(st, new_idx, new_d, ctx)


def _ld_merged(st: FuncSNEState, new_idx, new_d, ctx: AxisCtx):
    """The LD merge's result into the state: on a grid the lists are
    gathered and ``ld_d`` is not (H10b: it is re-derived from Y at the next
    refinement, so a zeros placeholder stands in)."""
    if ctx.all_rows is None:
        return st._replace(ld_idx=new_idx, ld_d=new_d)
    return st._replace(
        ld_idx=_gather_rows(new_idx, st.ld_idx, ctx.all_rows, ctx, "ld_idx"),
        ld_d=torch.zeros_like(st.ld_d))


def _forces_update(cfg: FuncSNEConfig, st: FuncSNEState, hp: HParams, rng,
                   ops: Ops, ctx: AxisCtx = AxisCtx()):
    """Forces, the Z estimate and the gains/momentum update.

    The default path bins every edge in B3 (deterministic fixed point).
    With ``scatter_fused=False`` (B5) or ``gather_fused=False`` (B7) the
    kernels return per-edge forces and the symmetrisation is one segment
    sum over [rows, HD edges, LD edges], the JAX package's three
    ``.at[].add`` calls in their order; it adds each row's terms in that
    fixed order, so both paths repeat bit for bit on the card.

    On a grid the rank computes the forces of its points x feat row slice
    into a full (N, d) buffer (float32), which is summed over the grid in
    bf16 (H10a), as is the Z estimate (float32); every rank then applies
    the same update to its replica.
    """
    n, d = cfg.n_points, cfg.dim_ld
    start, n_loc = _phase_rows(n, ctx.all_rows, ctx)
    ids = _slice_ids(start, n_loc, st.Y.device)
    if ctx.all_rows is not None and not cfg.cand_fused:
        rng = threefry.fold_in(rng, ctx.grid.axis_index(ctx.all_rows))
    hd_i = _rows(st.hd_idx, start, n_loc)
    hd_d = _rows(st.hd_d, start, n_loc)
    ld_i = _rows(st.ld_idx, start, n_loc)
    act_l = _rows(st.active, start, n_loc)
    n_act = st.active.float().sum().clamp_min(2.0)

    # attraction over the HD set: coef = p_{j|i} / (2N)  (Eq. 1)
    hd_valid = torch.isfinite(hd_d) & (hd_i != SENTINEL)
    hd_valid &= _take(st.active, hd_i)
    p = affinities.p_rows(hd_d, _rows(st.beta, start, n_loc), valid=hd_valid)
    coef_a = torch.where(hd_valid & act_l[:, None], p, 0.0) / (2.0 * n_act)

    # repulsion over the LD set; 0.5 because each directed edge acts on
    # both endpoints
    ld_valid = (ld_i != SENTINEL) & _take(st.active, ld_i)
    coef_r = 0.5 * (ld_valid & act_l[:, None]).float()

    nbr = [hd_i, ld_i]
    coef = [coef_a, coef_r]
    segments = (("attraction", cfg.k_hd), ("repulsion", cfg.k_ld))
    back = (True, True)
    have_neg = cfg.n_negatives > 0
    if have_neg:
        # far field by negative sampling (third term of Eq. 6)
        if cfg.cand_fused:
            salt = knn.hash3(rng, st.step, _TAG_NEG)
            draws = torch.arange(cfg.n_negatives, dtype=torch.int32,
                                 device=ids.device)[None, :]
            neg = knn.counter_randint(salt, ids[:, None], draws, n)
        else:
            neg = knn.sample_uniform(rng, n_loc, n, cfg.n_negatives,
                                     device=ids.device)
        neg = torch.where(neg == ids[:, None], (neg + 1) % n, neg)
        nbr.append(neg)
        coef.append((_take(st.active, neg) & act_l[:, None]).float())
        segments += (("repulsion", cfg.n_negatives),)
        back += (False,)
        scale_neg = (n_act - 1.0 - cfg.k_ld).clamp_min(1.0) / cfg.n_negatives

    scatter_fused = cfg.gather_fused and cfg.scatter_fused
    if scatter_fused:
        scats, wsums = ops.ne_forces_scatter(
            st.Y, ids, torch.cat(nbr, dim=1), torch.cat(coef, dim=1),
            hp.alpha, segments=segments, scatter_back=back)
    elif cfg.gather_fused:
        # the negatives' edges are never scattered back: not emitted
        aggs, edges, wsums = ops.ne_forces_gather(
            st.Y, ids, torch.cat(nbr, dim=1), torch.cat(coef, dim=1),
            hp.alpha, segments=segments, emit_edges=back)
    else:
        y_l = st.Y[ids.long()]
        outs = [ops.ne_forces(y_l, _take(st.Y, i), c, hp.alpha, mode=mode)
                for i, c, (mode, _) in zip(nbr, coef, segments)]
        aggs, edges, wsums = zip(*outs)

    # Z ~= sum_i [sum_{j in LD_i} w_ij + scale * mean_neg]; x2 undoes the
    # 0.5 symmetrisation coefficient of coef_r
    z_est = 2.0 * wsums[1].sum()
    if have_neg:
        z_est = z_est + scale_neg * wsums[2].sum()
    if ctx.all_rows is not None:
        z_est = ctx.grid.all_reduce(z_est, ctx.all_rows, "sum", tag="z")
    z_est = z_est.clamp_min(1e-8)
    zhat = torch.where(st.step == 0, z_est,
                       cfg.z_ema_decay * st.zhat
                       + (1.0 - cfg.z_ema_decay) * z_est)

    attr_s = hp.attraction * hp.exaggeration
    rep_s = hp.repulsion / zhat
    if scatter_fused:
        buf = attr_s * scats[0] + rep_s * scats[1]
        if have_neg:
            buf = buf + (rep_s * scale_neg) * scats[2]
    else:
        if have_neg:
            agg_q = attr_s * aggs[0] + rep_s * (aggs[1] + scale_neg * aggs[2])
        else:
            agg_q = attr_s * aggs[0] + rep_s * aggs[1]
        # each directed edge also acts on its neighbour row (int32 ids)
        tgt = [ids] + [i.clamp(0, n - 1).reshape(-1) for i in (hd_i, ld_i)]
        val = [agg_q] + [-(s * edge).reshape(-1, d)
                         for edge, s in ((edges[0], attr_s),
                                         (edges[1], rep_s))]
        buf = ops.segment_sum(torch.cat(tgt), torch.cat(val), n)
    if ctx.all_rows is not None:
        # H10a: accumulated in float32 here, summed over the wire in bf16
        buf = ctx.grid.all_reduce(buf.to(torch.bfloat16), ctx.all_rows,
                                  "sum", tag="forces").float()
    dY = 4.0 * buf

    # t-SNE gains + momentum (the same update on every replica)
    act = st.active[:, None]
    same = torch.sign(dY) == torch.sign(st.vel)
    gains = torch.where(same, st.gains + 0.2, st.gains * 0.8)
    # upper clip: unbounded gains turn negative-sampling noise into
    # diffusive expansion of the embedding
    gains = gains.clamp(0.01, 10.0)
    vel = hp.momentum * st.vel + hp.lr * gains * dY
    vel = torch.where(act, vel, 0.0)
    return st._replace(Y=st.Y + vel, vel=vel,
                       gains=torch.where(act, gains, st.gains), zhat=zhat)


def funcsne_step(cfg: FuncSNEConfig, st: FuncSNEState, X, hp: HParams,
                 ops: Ops = KERNELS, ctx: AxisCtx = AxisCtx()) -> FuncSNEState:
    """One FUnc-SNE iteration (see the module docstring).

    ``ops`` selects the kernels (default) or the plain versions; the state
    and ``X`` stay on their device either way.  ``ctx`` names the grid
    axes (:func:`make_distributed_step`); on a grid ``X`` is the rank's
    column block and every rank steps its replica of the state.
    """
    # stochastic HD refinement: p = 0.05 + 0.95 E[N_new/N]  (paper Sec. 3)
    p_ref = cfg.min_refresh_prob \
        + (1.0 - cfg.min_refresh_prob) * st.ema_new_frac
    p_ref = p_ref.clamp(0.0, 1.0)
    if cfg.cand_fused:
        base = knn.key_salt(st.rng)
        r_hd = r_ld = r_force = base
        u = knn.counter_uniform01(knn.hash3(base, st.step, _TAG_GATE))
        do_hd, step, rev_step = torch.stack([
            (u < p_ref).int(), st.step.int(), st.rev_step.int()]).tolist()
    else:
        # the one host sync: key words, step, cadence and p_ref's bits; the
        # key chain and the gate's draw then run on the host
        k0, k1, step, rev_step, p_bits = torch.cat([st.rng, torch.stack([
            st.step.long(), st.rev_step.long(),
            p_ref.view(torch.int32).long()])]).tolist()
        rng = threefry.fold_in(torch.tensor([k0, k1]), step)
        r_gate, r_hd, r_ld, r_force = threefry.split(rng, 4)
        p_host = torch.tensor(p_bits, dtype=torch.int32).view(torch.float32)
        do_hd = bool(threefry.bernoulli(r_gate, p_host))
    if do_hd:
        st = _hd_refine(cfg, st, X, r_hd, ops,
                        rev_due=step - rev_step >= cfg.rev_refresh, ctx=ctx)
    # The JAX step also requires any(new_flag); without a flag the refresh
    # changes nothing (beta is kept where no flag is set, and the cleared
    # flags are already clear), so that host sync is skipped here.
    if step % cfg.sigma_refresh_every == 0:
        st = _sigma_refresh(cfg, st, hp, ctx)
    st = _ld_refine(cfg, st, r_ld, ops, ctx)
    st = _forces_update(cfg, st, hp, r_force, ops, ctx)
    return st._replace(step=st.step + 1)


# --------------------------------------------------------------------------
# Initialisation


def pca_directions(X, d: int, n_iter: int = 24, rng=None):
    """Top-d PCA directions via subspace (power) iteration from the
    threefry draw ``normal(rng, (M, d))`` (``rng=None``: ``PRNGKey(0)``)."""
    if rng is None:
        rng = threefry.prng_key(0)
    Xc = X - X.mean(dim=0, keepdim=True)
    W = threefry.normal(rng, (X.shape[1], d), device=X.device)
    q = torch.linalg.qr(W)[0]
    for _ in range(n_iter):
        q = torch.linalg.qr(Xc.T @ (Xc @ q))[0]
    return q


def check_card_bounds(cfg: FuncSNEConfig):
    """Raise ``ValueError`` where ``cfg`` exceeds what the card's merge
    kernels take (B2/B4: K <= MAX_K list entries and C <= MAX_C candidate
    slots per row).  The embedding width has no bound."""
    c_hd = (cfg.c_hd_non + cfg.c_hd_ld + cfg.c_hd_ld_non + cfg.c_hd_rand
            + cfg.c_hd_rev)
    c_ld = cfg.c_ld_non + cfg.c_ld_hd + cfg.c_ld_rand
    for name, v, bound in (("k_hd", cfg.k_hd, MAX_K), ("k_ld", cfg.k_ld, MAX_K),
                           ("HD candidates per row", c_hd, MAX_C),
                           ("LD candidates per row", c_ld, MAX_C)):
        if v > bound:
            raise ValueError(
                f"{name} = {v} exceeds the card's merge-kernel bound {bound} "
                f"(K <= {MAX_K}, C <= {MAX_C})")


def validate_inputs(X, cfg: FuncSNEConfig, *, check_finite: bool = True):
    """Raise ``ValueError`` on an ``X`` (a float tensor) that does not fit
    ``cfg`` or would give a NaN embedding."""
    if X.ndim != 2:
        raise ValueError(
            f"X must be a 2-D (n, dim_hd) array, got shape {tuple(X.shape)}")
    if tuple(X.shape) != (cfg.n_points, cfg.dim_hd):
        raise ValueError(
            f"X shape {tuple(X.shape)} does not match cfg (n_points="
            f"{cfg.n_points}, dim_hd={cfg.dim_hd})")
    n = cfg.n_points
    for name, k in (("k_hd", cfg.k_hd), ("k_ld", cfg.k_ld)):
        if k >= n:
            raise ValueError(
                f"cfg.{name}={k} must be < n_points={n}: a row cannot "
                f"have {k} distinct neighbours among {n - 1} other points")
    if X.is_cuda:
        check_card_bounds(cfg)
    if check_finite and X.is_floating_point():
        bad = int((~torch.isfinite(X).all(dim=1)).sum())
        if bad:
            raise ValueError(
                f"X contains {bad} row(s) with non-finite (NaN/inf) "
                f"entries; clean or drop them before embedding")


def init_state(X, cfg: FuncSNEConfig, *, seed: int = 0, init: str = "pca",
               active=None, Y0=None, perplexity=30.0, validate: bool = True,
               device="cuda", ops: Ops = KERNELS) -> FuncSNEState:
    """Initial state on ``device`` (CUDA unless the caller asks for CPU).

    The random start is drawn as the JAX ``init_state(PRNGKey(seed), ...)``
    draws it: ``split(PRNGKey(seed), 4)`` gives the PCA probe or random Y
    (``r_y``), the initial HD and LD lists (``r_hd``, ``r_ld``) and the
    state's key (``r_state``).  The lists and key equal the JAX state's;
    Y carries ``threefry.normal``'s tolerance.
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
    n, d = cfg.n_points, cfg.dim_ld
    if validate:
        validate_inputs(X, cfg)
    r_y, r_hd, r_ld, r_state = threefry.split(threefry.prng_key(seed), 4)
    if Y0 is not None:
        Y = torch.as_tensor(Y0, dtype=torch.float32).to(dev)
    elif init == "pca":
        W = pca_directions(X, d, rng=r_y)
        Y = (X - X.mean(dim=0)) @ W
        Y = Y / Y.std(correction=0).clamp_min(1e-8) * 1e-2
    else:
        Y = threefry.normal(r_y, (n, d), device=dev) * 1e-2
    Y = Y.to(torch.float32).contiguous()
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    active = torch.as_tensor(active, dtype=torch.bool).to(dev)

    ids = torch.arange(n, dtype=torch.int32, device=dev)
    hd_idx = knn.init_knn_idx(r_hd, n, n, cfg.k_hd, device=dev)
    hd_d = _row_sqdist(cfg, X, ids, hd_idx, ops)
    hd_d = torch.where(_take(active, hd_idx) & active[:, None], hd_d,
                       torch.inf)
    hd_d, order = torch.sort(hd_d, dim=1, stable=True)
    hd_idx = torch.gather(hd_idx, 1, order)

    ld_idx = knn.init_knn_idx(r_ld, n, n, cfg.k_ld, device=dev)
    if cfg.gather_fused:
        ld_d = ops.pairwise_sqdist_gather(Y, ids, ld_idx)
    else:
        ld_d = ((Y[:, None, :] - _take(Y, ld_idx)) ** 2).sum(-1)
    ld_d = torch.where(_take(active, ld_idx) & active[:, None], ld_d,
                       torch.inf)
    rng = r_state.to(dev)

    beta = affinities.solve_beta(hd_d, perplexity, n_iter=24)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)
    return FuncSNEState(
        Y=Y, vel=torch.zeros((n, d), dtype=torch.float32, device=dev),
        gains=torch.ones((n, d), dtype=torch.float32, device=dev),
        hd_idx=hd_idx.contiguous(), hd_d=hd_d.contiguous(),
        ld_idx=ld_idx, ld_d=ld_d, beta=beta,
        new_flag=torch.ones((n,), dtype=torch.bool, device=dev),
        active=active, ema_new_frac=scalar(1.0, torch.float32),
        zhat=scalar(1.0, torch.float32), step=scalar(0, torch.int32),
        rng=rng,
        # rev_step one period in the past: the first refinement rebuilds
        rev_idx=torch.zeros((n, cfg.c_hd_rev), dtype=torch.int32,
                            device=dev),
        rev_step=scalar(-cfg.rev_refresh, torch.int32))


def make_step(cfg: FuncSNEConfig):
    """``step(st, X, hp) -> st``: one :func:`funcsne_step` of ``cfg`` on the
    kernels (the JAX package's jitted step; PyTorch runs it eagerly)."""
    return functools.partial(funcsne_step, cfg)


# --------------------------------------------------------------------------
# Chunk runner and fit


class ChunkMetrics(NamedTuple):
    """Per-chunk telemetry: 0-dim tensors, read once per chunk."""
    step: Any           # () int32 global iteration count after the chunk
    n_snapshots: Any    # () int32 ring slots written this chunk
    disp_ema: Any       # () f32 EMA over the chunk of mean |vel| (active)
    zhat: Any           # () f32 Z estimator at chunk end
    ema_new_frac: Any   # () f32 HD-refinement EMA at chunk end
    finite_frac: Any    # () f32 MIN over the chunk of the finite fraction
    #                     of Y entries on active rows (1.0 = healthy)
    y_max_abs: Any      # () f32 MAX over the chunk of max |Y| (active,
    #                     finite entries)
    bad_step: Any       # () int32 first step whose Y held a non-finite
    #                     active entry; -1 = none this chunk


_METRICS_DECAY = 0.9


def make_chunked_step(cfg: FuncSNEConfig, T: int, *, schedule=None,
                      n_iter=None, snapshot_every: int = 0,
                      health_metrics: bool = True):
    """``chunk(st, X, hp) -> (st, snapshots, ChunkMetrics)``: ``T`` steps.

    The counterpart of the JAX ``make_chunked_step``: the schedule is
    evaluated from the carried ``st.step``, the per-step scalars fold into
    :class:`ChunkMetrics` on the device, and ``snapshots`` is a device
    ring of ``T // snapshot_every + 1`` (n, d) slots (0 slots when
    ``snapshot_every`` is 0) that captures Y after every step whose new
    ``st.step`` is a multiple of ``snapshot_every``; the first
    ``metrics.n_snapshots`` slots are written.

    The health telemetry (the finite fraction of the active rows' Y, min
    over the chunk; their max |Y|; the first step with a non-finite entry)
    folds into the same metrics, read by ``fit``'s resilience policy in
    its one read a chunk.  ``health_metrics=False`` skips it: the three
    fields keep their initial values 1.0, 0.0 and -1.
    """
    return _chunk_fn(cfg, T, schedule=schedule, n_iter=n_iter,
                     snapshot_every=snapshot_every,
                     health_metrics=health_metrics)


def _chunk_fn(cfg: FuncSNEConfig, T: int, *, schedule=None, n_iter=None,
              snapshot_every: int = 0, ctx: AxisCtx = AxisCtx(),
              health_metrics: bool = True, health_reduce: bool = True):
    """The chunk runner of :func:`make_chunked_step` on ``ctx``'s grid.

    On a grid with ``health_reduce`` (the default) each rank probes only
    its own points x feat row slice of Y (the rows whose updates it
    computed) and the scalars are reduced over the grid once a chunk:
    ``finite_frac`` by min, ``y_max_abs`` by max, ``bad_step`` to the
    earliest trip.  So a NaN confined to one rank's replica trips every
    rank's probe.  ``health_reduce=False`` keeps the per-replica probe
    (every rank reads its whole replica, nothing reduced): the reference's
    positive control, not for production.
    """
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if schedule is not None and n_iter is None:
        raise ValueError("schedule requires a static n_iter horizon")
    n, d = cfg.n_points, cfg.dim_ld
    n_snap = (T // snapshot_every + 1) if snapshot_every else 0
    decay = _METRICS_DECAY
    health_axes = ctx.all_rows if health_reduce else None
    h_start, h_loc = _phase_rows(n, health_axes, ctx)

    def chunk(st: FuncSNEState, X, hp: HParams):
        dev = st.Y.device
        snaps = torch.zeros((n_snap, n, d), dtype=torch.float32, device=dev)
        k = torch.zeros((), dtype=torch.int32, device=dev)
        disp = torch.zeros((), dtype=torch.float32, device=dev)
        ff_min = torch.ones((), dtype=torch.float32, device=dev)
        ymax = torch.zeros((), dtype=torch.float32, device=dev)
        bad = torch.full((), -1, dtype=torch.int32, device=dev)
        for _ in range(T):
            hp_t = schedule(st.step, n_iter, hp) if schedule else hp
            st = funcsne_step(cfg, st, X, hp_t, ctx=ctx)
            act_col = st.active[:, None].float()
            n_act = st.active.float().sum()
            act_disp = (st.vel.abs() * act_col).sum() \
                / (n_act.clamp_min(1.0) * d)
            disp = decay * disp + (1.0 - decay) * act_disp
            if health_metrics:
                y_h = _rows(st.Y, h_start, h_loc)
                a_h = _rows(st.active, h_start, h_loc)
                a_col = a_h[:, None].float()
                na_h = a_h.float().sum()
                finite = torch.isfinite(y_h)
                ff = (finite.float() * a_col).sum() \
                    / (na_h * d).clamp_min(1.0)
                # a slice with no active rows is healthy: it must not
                # min a 0/... into the reduced probe
                ff = torch.where(na_h > 0, ff, 1.0)
                step_max = torch.where(finite & (a_col > 0), y_h.abs(),
                                       0.0).max()
                bad = torch.where((bad < 0) & (ff < 1.0), st.step - 1, bad)
                ff_min = torch.minimum(ff_min, ff)
                ymax = torch.maximum(ymax, step_max)
            if n_snap:
                # written on the device, as the JAX ring's cond: slot k is
                # overwritten with itself when the step is not due
                due = st.step % snapshot_every == 0
                slot = k.clamp(0, n_snap - 1).long().reshape(1)
                snaps.index_copy_(0, slot, torch.where(
                    due, st.Y, snaps.index_select(0, slot)[0])[None])
                k = k + due.int()
        if health_metrics and health_axes is not None:
            # once a chunk: min/max commute with the per-step folds above
            grid = ctx.grid
            ff_min = grid.all_reduce(ff_min, health_axes, "min",
                                     tag="health")
            ymax = grid.all_reduce(ymax, health_axes, "max", tag="health")
            # the earliest trip; none (-1) goes in as the largest int32
            no_bad = torch.iinfo(torch.int32).max
            bad = grid.all_reduce(torch.where(bad < 0, no_bad, bad),
                                  health_axes, "min", tag="health")
            bad = torch.where(bad == no_bad, -1, bad)
        return st, snaps, ChunkMetrics(
            step=st.step, n_snapshots=k, disp_ema=disp, zhat=st.zhat,
            ema_new_frac=st.ema_new_frac, finite_frac=ff_min, y_max_abs=ymax,
            bad_step=bad)

    return chunk


def make_distributed_step(cfg: FuncSNEConfig, mesh, *, points_axes=("data",),
                          feat_axis="model", chunk: int = None,
                          schedule=None, n_iter=None,
                          snapshot_every: int = 0,
                          health_metrics: bool = True,
                          health_reduce: bool = True):
    """The step on a grid of ranks (``mesh``: a
    :class:`~repro_torch.launch.mesh.Grid`); returns ``(fn, ctx)``.

    Called on every rank of the grid, with the same arguments; ``fn`` is
    then called on every rank with the rank's replica of the state, its
    column block of X (``mesh.column_block(X, feat_axis)``) and the
    hyperparameters.  ``chunk=None`` gives ``fn(st, X, hp) -> st``, one
    step; ``chunk=T`` the chunk runner, ``fn(st, X, hp) -> (st, snaps,
    ChunkMetrics)``, whose steps are the same distributed steps, so a
    chunk equals T of them one by one.  Its health telemetry is reduced
    over the grid (``health_reduce``, see :func:`_chunk_fn`).
    """
    ctx = AxisCtx(points=tuple(points_axes), feat=feat_axis, grid=mesh)
    width = mesh.axis_size(feat_axis)

    def checked(X):
        if X.shape[1] * width != cfg.dim_hd:
            raise ValueError(
                f"X has {X.shape[1]} columns: a rank takes its block of "
                f"{cfg.dim_hd} // {width} (mesh.column_block)")
        return X

    if chunk is None:
        def step(st, X, hp):
            return funcsne_step(cfg, st, checked(X), hp, ctx=ctx)
        return step, ctx

    body = _chunk_fn(cfg, chunk, schedule=schedule, n_iter=n_iter,
                     snapshot_every=snapshot_every, ctx=ctx,
                     health_metrics=health_metrics,
                     health_reduce=health_reduce)

    def run(st, X, hp):
        return body(st, checked(X), hp)
    return run, ctx


def default_schedule(it, n_iter: int, hp: HParams) -> HParams:
    """Early exaggeration, then a linear lr decay (as the JAX schedule,
    evaluated on the device from the carried step)."""
    ee_until = max(1, n_iter // 4)
    it = torch.as_tensor(it, dtype=torch.int32).to(hp.lr.device)
    early = it < ee_until
    ex = torch.where(early, 12.0, 1.0) * hp.exaggeration
    mom = torch.where(early, 0.5, hp.momentum)
    denom = torch.tensor(float(max(1, n_iter - ee_until)),
                         dtype=torch.float32, device=hp.lr.device)
    frac = ((it - ee_until).float() / denom).clamp_min(0.0)
    lr = hp.lr * (1.0 - 0.9 * frac)
    return hp._replace(exaggeration=ex, momentum=mom, lr=lr)


# --------------------------------------------------------------------------
# Session controls: rescale, add/remove points, audit


def rescale_embedding(st: FuncSNEState, factor: float = 0.01):
    """The paper's 'implosion button': rescale Y so gradients matter again."""
    return st._replace(Y=st.Y * factor, vel=st.vel * 0.0)


def add_points(st: FuncSNEState, ids, key) -> FuncSNEState:
    """Activate rows (dynamic datasets); the caller updates X first.

    Each row gets the fresh HD list ``(id + 1 + init_knn_idx(key, len(ids),
    n - 1, k)) % n`` (the JAX package's lists for the same threefry
    ``key``), distances +inf and its new flag set, so the iterative KNN
    refreshes it lazily.
    """
    dev = st.Y.device
    ids = torch.as_tensor(ids, dtype=torch.int32).to(dev)
    n = st.active.shape[0]
    fresh = (ids[:, None] + 1 + knn.init_knn_idx(
        key, ids.shape[0], n - 1, st.hd_idx.shape[1], device=dev)) % n
    rows = ids.long()
    return st._replace(
        active=st.active.index_fill(0, rows, True),
        hd_idx=st.hd_idx.index_copy(0, rows, fresh.to(torch.int32)),
        hd_d=st.hd_d.index_fill(0, rows, torch.inf),
        new_flag=st.new_flag.index_fill(0, rows, True))


def remove_points(st: FuncSNEState, ids) -> FuncSNEState:
    """Deactivate rows: they stop moving and stop acting on the others."""
    rows = torch.as_tensor(ids).to(st.Y.device).long()
    return st._replace(active=st.active.index_fill(0, rows, False),
                       new_flag=st.new_flag.index_fill(0, rows, False))


def _copy_state(st: FuncSNEState) -> FuncSNEState:
    return FuncSNEState(*(t.clone() for t in st))


def _scaled_hp(hp: HParams, lr_scale: float, ex_scale: float) -> HParams:
    """Retry backoff applied to the hyperparameters.

    Identity at scale 1.0 (no new tensors), so a run that never trips a
    health probe is bit-identical to one without a policy; the schedule
    composes on top (it multiplies ``hp.lr``), so backoff scales the whole
    annealing curve rather than fighting it.
    """
    if lr_scale == 1.0 and ex_scale == 1.0:
        return hp

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=hp.lr.device)
    return hp._replace(lr=hp.lr * f32(lr_scale),
                       exaggeration=hp.exaggeration * f32(ex_scale))


def _read_host(values):
    """A NamedTuple of 0-dim tensors on one device as Python numbers (float
    or int, by dtype), in one device-to-host copy."""
    got = torch.stack([v.to(torch.float64) for v in values]).tolist()
    return type(values)(*(g if v.is_floating_point() else int(g)
                          for v, g in zip(values, got)))


def _checkpoint_state(st: FuncSNEState) -> FuncSNEState:
    """The state as the JAX package checkpoints it: numpy fields, the key
    as uint32 words (``core.convert``)."""
    from repro_torch.core import convert
    return FuncSNEState(**convert.state_to_numpy(st))


class AuditResult(NamedTuple):
    """Violation counts from :func:`audit_state`: 0-dim int32 tensors, all
    zero for a healthy state."""
    hd_oob: Any         # hd_idx entries outside [0, n) (mod SENTINEL)
    ld_oob: Any         # ld_idx entries outside [0, n) (mod SENTINEL)
    rev_oob: Any        # rev_idx entries outside [0, n) (mod SENTINEL)
    hd_dup: Any         # per-row duplicate hd neighbours (mod SENTINEL)
    ld_dup: Any         # per-row duplicate ld neighbours (mod SENTINEL)
    hd_sentinel: Any    # SENTINEL hd slots whose distance is not +inf
    y_nonfinite: Any    # non-finite Y entries on active rows
    x_nonfinite: Any    # non-finite X entries on active rows (0 if no X)


def _count(mask):
    return mask.sum(dtype=torch.int32)


def audit_state(st: FuncSNEState, cfg: FuncSNEConfig,
                X=None) -> AuditResult:
    """Invariant audit of a state on its device: list and reverse-edge ids
    in [0, n) (SENTINEL aside), no duplicate within a row (sort and compare
    neighbours), SENTINEL HD slots at +inf distance (a finite one would
    resurrect a phantom neighbour), and finite Y (and X, when given) on
    active rows.  Nothing is read back: the caller reads the counts."""
    n = cfg.n_points
    zero = torch.zeros((), dtype=torch.int32, device=st.Y.device)

    def oob(idx):
        if idx.ndim != 2 or idx.shape[1] == 0:
            return zero
        return _count((idx != SENTINEL) & ((idx < 0) | (idx >= n)))

    def dups(idx):
        if idx.ndim != 2 or idx.shape[1] < 2:
            return zero
        s = torch.sort(idx, dim=1).values
        return _count((s[:, 1:] == s[:, :-1]) & (s[:, 1:] != SENTINEL))

    act_col = st.active[:, None]
    return AuditResult(
        hd_oob=oob(st.hd_idx), ld_oob=oob(st.ld_idx), rev_oob=oob(st.rev_idx),
        hd_dup=dups(st.hd_idx), ld_dup=dups(st.ld_idx),
        hd_sentinel=_count((st.hd_idx == SENTINEL) & ~torch.isinf(st.hd_d)),
        y_nonfinite=_count(~torch.isfinite(st.Y) & act_col),
        x_nonfinite=zero if X is None
        else _count(~torch.isfinite(X) & act_col))


# --------------------------------------------------------------------------
# fit


def _host_only(schedule, n_iter: int) -> bool:
    """Whether ``schedule`` needs a value on the host: it is called once
    with ``it`` and every hparams field as 0-dim meta tensors (shapes, no
    data), and one that reads a value (``int(it)``, ``bool``, ``.item()``)
    raises there.  The counterpart of the JAX ``fit``'s trace with an
    abstract ``it``."""
    def meta(dtype):
        return torch.zeros((), dtype=dtype, device="meta")
    hp = HParams(*(meta(torch.float32) for _ in HParams._fields))
    try:
        schedule(meta(torch.int32), n_iter, hp)
    except RuntimeError as e:
        if "meta tensor" not in str(e):
            raise
        return True
    return False


def fit(X, *, cfg: FuncSNEConfig = None, n_iter: int = 750, seed: int = 0,
        hparams: HParams = None, schedule=None, init: str = "pca",
        chunk_size: int = None, state: FuncSNEState = None,
        validate: bool = True, device="cuda", snapshot_every: int = 0,
        callback=None, early_stop=None, auto_rescale=None, resilience=None,
        resume_from=None):
    """Embed ``X``: ``init_state`` (or ``state``, whose ``n_iter`` then
    counts further steps) then chunks of ``chunk_size`` steps.

    Returns ``(state, snapshots)`` as the JAX ``fit``: ``snapshots`` is
    the list of numpy (n, d) copies of Y after every step whose count is
    a multiple of ``snapshot_every`` (empty when it is 0), drained from
    each chunk's ring.

    ``callback(it, st)`` runs after each chunk with its last step's index
    (``chunk_size`` defaults to 1 when one is given).  After each chunk
    the EMA'd mean displacement of active rows, ``metrics.disp_ema``,
    normalised by its saturation ``1 - 0.9**T``, is compared with
    ``early_stop`` (below it: stop) and then with ``auto_rescale`` (below
    it, while steps remain: :func:`rescale_embedding`).

    ``resilience`` (a :class:`~repro_torch.core.resilience.ResiliencePolicy`)
    arms the fault-tolerance layer, step for step the JAX ``fit``'s:
    before each chunk the state is cloned (the rollback anchor; a scripted
    fault of ``runtime.faults`` poisons the copy), and after it the health
    fields of :class:`ChunkMetrics` are read in one copy and checked (and
    every ``audit_every`` healthy chunks :func:`audit_state`).  A tripped
    probe rolls back to the anchor and retries with the learning rate (and
    exaggeration) backed off, raising
    :class:`~repro_torch.core.resilience.EmbeddingDiverged` once
    ``max_retries`` consecutive retries fail.  With
    ``policy.checkpoint_dir`` the whole state is written every
    ``checkpoint_every`` healthy chunks through
    :class:`~repro_torch.checkpoint.Checkpointer`, in the JAX package's
    format; a straggler or hang alarm of the chunk-time watchdog commits
    the boundary at once.  ``policy.sticky_fallback`` enables the guarded
    calls of ``kernels.fallback`` for the run: on the CPU a kernel family
    whose call raises is demoted to its plain version (a warning, and an
    event in ``policy.events``); on the card the fault is a
    ``kernel_fault`` event and propagates, and the run resumes from its
    last checkpoint.  A clean run under a policy is bit-identical to
    ``resilience=None``.

    ``resume_from`` (a checkpoint directory) restores the newest boundary
    that verifies (each damaged one skipped is a ``checkpoint_fallback``
    event, or a warning without a policy), with its iteration and backoff
    scales; a checkpoint of another config raises
    ``CheckpointIncompatible``.  A resumed run is bit-identical to the
    uninterrupted one.

    A schedule that needs ``it`` on the host (``int(it)``, a branch on it)
    runs in the per-step host loop instead, as the JAX ``fit`` routes one
    that cannot be traced; ``state``, ``resilience`` and ``resume_from``
    raise ``ValueError`` with such a schedule.
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
    if cfg is None:
        cfg = FuncSNEConfig(n_points=X.shape[0], dim_hd=X.shape[1])
    if validate:
        validate_inputs(X, cfg)
    if hparams is None:
        hparams = default_hparams(cfg.n_points, device=dev)
    if schedule is None:
        schedule = default_schedule
    if chunk_size is None:
        chunk_size = 1 if callback is not None else min(50, max(1, n_iter))
    host_only = _host_only(schedule, n_iter)
    if host_only and (resilience is not None or resume_from is not None
                      or state is not None):
        raise ValueError(
            "resilience / resume_from / state require a traceable schedule "
            "(the per-step host-loop fallback does not support them); use "
            "a schedule evaluable with a traced `it`")
    if host_only:
        return _fit_host_loop(X, cfg, n_iter, seed, hparams, schedule, init,
                              snapshot_every, callback, early_stop,
                              auto_rescale)
    st = state if state is not None else init_state(
        X, cfg, seed=seed, init=init, perplexity=hparams.perplexity,
        validate=False, device=dev)

    policy = resilience
    ck = monitor = None
    start_it = 0
    lr_scale = ex_scale = 1.0
    if policy is not None:
        if policy.checkpoint_dir is not None:
            ck = Checkpointer(policy.checkpoint_dir,
                              keep_last=policy.keep_last)
        monitor = StepTimeMonitor(z_thresh=policy.straggler_z,
                                  hang_timeout=policy.hang_timeout,
                                  warmup_steps=policy.straggler_warmup)
    if resume_from is not None:
        rck = ck if (ck is not None
                     and str(ck.dir) == str(resume_from)) else \
            Checkpointer(resume_from)
        # the newest boundary that verifies: a damaged one (torn write, bit
        # flip, lost file) falls back to the one before; a config mismatch
        # raises CheckpointIncompatible
        st, meta, fbs = rck.restore_verified(
            st, expect_compat=cfg_compat(cfg))
        for fb in fbs:
            if policy is not None:
                policy.log("checkpoint_fallback", **fb)
            else:
                warnings.warn(
                    f"[checkpoint] skipping damaged boundary step "
                    f"{fb['step']}: {fb['reason']}", RuntimeWarning)
        start_it = int(meta["step"])
        lr_scale = float(meta.get("lr_scale", 1.0))
        ex_scale = float(meta.get("ex_scale", 1.0))

    snapshots = []
    chunks = {}
    it = start_it
    retries = 0
    n_healthy = 0       # healthy chunks since the start (checkpoint cadence)
    fb_seen = fallback.n_events()
    guard = fallback.enabled(policy.sticky_fallback) \
        if policy is not None else contextlib.nullcontext()
    with contextlib.ExitStack() as stack:
        stack.enter_context(guard)
        if ck is not None:
            # every exit path (EmbeddingDiverged, Preempted, a raising
            # callback) joins the write in flight, so the last boundary is
            # on disk for a resume; close() warns about an unobserved write
            # error instead of masking the exception in flight
            stack.callback(ck.close)
        while it < n_iter:
            T = min(chunk_size, n_iter - it)
            if T not in chunks:
                # only the policy reads the health telemetry
                chunks[T] = make_chunked_step(
                    cfg, T, schedule=schedule, n_iter=n_iter,
                    snapshot_every=snapshot_every,
                    health_metrics=policy is not None)
            hp_run = _scaled_hp(hparams, lr_scale, ex_scale)
            if policy is not None or faults.current() is not None:
                # the live `st` is the rollback anchor: the chunk runs on a
                # copy, and a scripted fault poisons the copy, as a
                # divergence inside the chunk would
                st_in = faults.corrupt_state(_copy_state(st), it)
            else:
                st_in = st
            t0 = time.perf_counter()
            try:
                st_out, snaps, metrics = chunks[T](st_in, X, hp_run)
            except Exception:
                # a kernel fault on the card propagates: its event goes
                # into the policy's log first
                if policy is not None:
                    for e in fallback.events(fb_seen):
                        policy.log(**e)
                raise
            alarm = None
            if policy is not None:
                m = _read_host(metrics)     # the one host read a chunk
                alarm = monitor.observe(time.perf_counter() - t0)
                if alarm is not None:
                    policy.log("straggler", step=it, alarm=alarm)
                for e in fallback.events(fb_seen):
                    policy.log(**e)
                fb_seen = fallback.n_events()
                reason = policy.check(m)
                if reason is None and policy.audit_every \
                        and (n_healthy + 1) % policy.audit_every == 0:
                    # the chunk-boundary audit catches index corruption
                    # the finite-fraction probes cannot see; a violation
                    # takes the same rollback path
                    reason = policy.audit_check(
                        _read_host(audit_state(st_out, cfg, X)))
                    if reason is not None:
                        policy.log("audit_violation", step=it,
                                   reason=reason)
                if reason is not None:
                    if retries >= policy.max_retries:
                        policy.log("giving_up", step=it, reason=reason,
                                   retries=retries)
                        raise EmbeddingDiverged(it, reason, retries,
                                                policy.events)
                    retries += 1
                    lr_scale *= policy.lr_backoff
                    ex_scale *= policy.exaggeration_backoff
                    policy.log("rollback", step=it, reason=reason,
                               retry=retries, lr_scale=lr_scale,
                               ex_scale=ex_scale)
                    continue    # `st` still holds the last healthy state
                retries = 0
            else:
                m = metrics
            st = st_out
            if snapshot_every:
                taken = int(m.n_snapshots)
                snapshots.extend(list(snaps[:taken].cpu().numpy()))
            if callback is not None:
                callback(it + T - 1, st)
            it += T
            if policy is not None:
                n_healthy += 1
                if ck is not None:
                    meta = {"lr_scale": lr_scale, "ex_scale": ex_scale,
                            "compat": cfg_compat(cfg)}
                    saved = n_healthy % policy.checkpoint_every == 0
                    if saved:
                        ck.save(it, _checkpoint_state(st), metadata=meta)
                    if alarm is not None:
                        # a straggler or hang alarm commits this boundary
                        # before the next chunk, so that a kill that
                        # follows loses at most one chunk
                        if saved:
                            ck.wait()       # land the write in flight
                        else:
                            ck.save(it, _checkpoint_state(st),
                                    metadata=meta, blocking=True)
                        policy.log("early_checkpoint", step=it,
                                   alarm=alarm)
            # scripted damage to the newest committed checkpoint (the hook
            # waits for the write in flight): exercises the verified
            # restore's fallback chain on resume
            faults.maybe_corrupt_checkpoint(it, ck)
            # a simulated kill between chunks; the ExitStack's ck.close()
            # lets the write in flight land, so the boundary just saved is
            # committed for a resume
            faults.maybe_preempt(it)
            if early_stop is not None or auto_rescale is not None:
                # in steady-state per-step units whatever T (at T = 1 the
                # factor is the single step's weight 0.1: the host loop's
                # act_disp)
                disp = float(m.disp_ema) / (1.0 - _METRICS_DECAY ** T)
                if early_stop is not None and disp < early_stop:
                    break
                if auto_rescale is not None and it < n_iter \
                        and disp < auto_rescale:
                    st = rescale_embedding(st)
        if ck is not None:
            ck.wait()   # surface an async write failure before returning:
            #             the last checkpoint of a run must not vanish
            #             silently (close() above only warns)
    return st, snapshots


def _fit_host_loop(X, cfg, n_iter, seed, hparams, schedule, init,
                   snapshot_every, callback, early_stop=None,
                   auto_rescale=None):
    """The per-step loop for schedules that need a Python ``it``."""
    st = init_state(X, cfg, seed=seed, init=init,
                    perplexity=hparams.perplexity, validate=False,
                    device=X.device)
    step = make_step(cfg)
    snapshots = []
    for it in range(n_iter):
        st = step(st, X, schedule(it, n_iter, hparams))
        if snapshot_every and (it + 1) % snapshot_every == 0:
            snapshots.append(st.Y.cpu().numpy())
        if callback is not None:
            callback(it, st)
        if early_stop is not None or auto_rescale is not None:
            # the quantity fit derives from ChunkMetrics at T = 1
            act = st.active.float()
            n_act = max(float(act.sum()), 1.0)
            act_disp = float((st.vel.abs() * act[:, None]).sum()) \
                / (n_act * cfg.dim_ld)
            if early_stop is not None and act_disp < early_stop:
                break
            if auto_rescale is not None and it + 1 < n_iter \
                    and act_disp < auto_rescale:
                st = rescale_embedding(st)
    return st, snapshots
