"""FUnc-SNE's single-device path (port of ``repro.core.funcsne``).

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

PyTorch runs eagerly, so the chunk runner (``make_chunked_step``) is a
Python loop over steps; the gate's branch and the reverse-table cadence are
one host sync per step.  On the threefry path that sync also fetches the
key words, so the scalar key chain (``fold_in``, ``split``, the gate's
``bernoulli``) runs on the host and only the (n, c) draws on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import affinities
from repro_torch.core import knn
from repro_torch.core import threefry
from repro_torch.core.knn import SENTINEL
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


def _take(arr, idx):
    """Gather rows with SENTINEL-safe clipping."""
    return arr[idx.long().clamp(0, arr.shape[0] - 1)]


def _ids(st: FuncSNEState):
    return torch.arange(st.Y.shape[0], dtype=torch.int32, device=st.Y.device)


# --------------------------------------------------------------------------
# Phases


def _row_sqdist(cfg: FuncSNEConfig, X, ids, cand, ops: Ops):
    """Squared HD distances rows -> candidates: B1 on indices, or with
    ``gather_fused=False`` B6 on the pre-gathered rows."""
    if cfg.gather_fused:
        return ops.pairwise_sqdist_gather(X, ids, cand)
    return ops.pairwise_sqdist(X[ids.long()], _take(X, cand))


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
               rev_due: bool = False):
    """HD refinement; ``rng`` is the base salt (counter RNG) or the step's
    threefry key, and ``rev_due`` rebuilds the reverse table first."""
    n = cfg.n_points
    ids = _ids(st)
    dev = ids.device
    use_kernel = cfg.merge_fused and cfg.gather_fused
    if cfg.cand_fused:
        salt = knn.hash3(rng, st.step, _TAG_HD)
        if cfg.c_hd_rev and rev_due:
            st = _rev_update(cfg, st, knn.counter_fill(
                knn.hash3(rng, st.step, _TAG_REV), n, cfg.c_hd_rev))
        rev = st.rev_idx if cfg.c_hd_rev else None
        sources = (("two_hop", 0, 0, cfg.c_hd_non),
                   ("one_hop", 1, cfg.c_hd_ld),
                   ("two_hop", 1, 1, cfg.c_hd_ld_non),
                   ("uniform", cfg.c_hd_rand),
                   ("extra", cfg.c_hd_rev))
        firsts, seconds = (st.hd_idx, st.ld_idx), (st.hd_idx, st.ld_idx)
        if use_kernel:
            new_idx, new_d, improved = ops.knn_merge_cand(
                X, ids, st.hd_idx, st.hd_d, salt=salt, sources=sources,
                first_tables=firsts, second_tables=seconds, extra=rev,
                active=st.active)
            return _hd_merged(cfg, st, new_idx, new_d, improved)
        cand = knn.counter_candidates(salt, ids, sources, firsts, seconds,
                                      n_total=n, extra=rev)
    else:
        r = threefry.split(rng, 5)
        parts = []
        if cfg.c_hd_non:
            parts.append(knn.sample_hops(r[0], st.hd_idx, st.hd_idx, ids,
                                         cfg.c_hd_non))
        if cfg.c_hd_ld:
            parts.append(knn.sample_direct(r[1], st.ld_idx, cfg.c_hd_ld))
        if cfg.c_hd_ld_non:
            parts.append(knn.sample_hops(r[2], st.ld_idx, st.ld_idx, ids,
                                         cfg.c_hd_ld_non))
        if cfg.c_hd_rand:
            parts.append(knn.sample_uniform(r[3], n, n, cfg.c_hd_rand,
                                            device=dev))
        if cfg.c_hd_rev:
            if rev_due:
                st = _rev_update(cfg, st, knn.sample_uniform(
                    r[4], n, n, cfg.c_hd_rev, device=dev))
            parts.append(st.rev_idx)
        cand = torch.cat(parts, dim=1)
    cand_active = _take(st.active, cand)
    if use_kernel:
        new_idx, new_d, improved = ops.knn_merge(
            X, ids, st.hd_idx, st.hd_d, cand, cand_active=cand_active)
    else:
        valid = knn.dedup_candidates(ids, st.hd_idx, cand) & cand_active
        cand_d = _row_sqdist(cfg, X, ids, cand, ops)
        new_idx, new_d, improved = knn.merge_knn(st.hd_idx, st.hd_d, cand,
                                                 cand_d, valid)
    return _hd_merged(cfg, st, new_idx, new_d, improved)


def _hd_merged(cfg: FuncSNEConfig, st: FuncSNEState, new_idx, new_d,
               improved):
    """The HD merge's result into the state, with the E[N_new/N] EMA."""
    n_act = st.active.float().sum().clamp_min(1.0)
    frac = (improved & st.active).float().sum() / n_act
    ema = cfg.ema_decay * st.ema_new_frac + (1.0 - cfg.ema_decay) * frac
    return st._replace(hd_idx=new_idx, hd_d=new_d,
                       new_flag=st.new_flag | improved, ema_new_frac=ema)


def _sigma_refresh(cfg: FuncSNEConfig, st: FuncSNEState, hp: HParams):
    valid = torch.isfinite(st.hd_d) & (st.hd_idx != SENTINEL)
    valid &= _take(st.active, st.hd_idx)
    solved = affinities.solve_beta(st.hd_d, hp.perplexity, valid=valid,
                                   beta0=st.beta, n_iter=24)
    return st._replace(beta=torch.where(st.new_flag, solved, st.beta),
                       new_flag=torch.zeros_like(st.new_flag))


def _ld_refine(cfg: FuncSNEConfig, st: FuncSNEState, rng, ops: Ops):
    n = cfg.n_points
    ids = _ids(st)
    use_kernel = cfg.merge_fused and cfg.gather_fused
    cur_valid = (st.ld_idx != SENTINEL) & _take(st.active, st.ld_idx)
    if cfg.cand_fused:
        salt = knn.hash3(rng, st.step, _TAG_LD)
        sources = (("two_hop", 0, 0, cfg.c_ld_non),
                   ("one_hop", 1, cfg.c_ld_hd),
                   ("uniform", cfg.c_ld_rand))
        firsts, seconds = (st.ld_idx, st.hd_idx), (st.ld_idx,)
        if use_kernel:
            new_idx, new_d, _ = ops.knn_merge_cand(
                st.Y, ids, st.ld_idx, None, salt=salt, sources=sources,
                first_tables=firsts, second_tables=seconds, active=st.active,
                cur_valid=cur_valid)
            return st._replace(ld_idx=new_idx, ld_d=new_d)
        cand = knn.counter_candidates(salt, ids, sources, firsts, seconds,
                                      n_total=n)
    else:
        r = threefry.split(rng, 3)
        parts = []
        if cfg.c_ld_non:
            parts.append(knn.sample_hops(r[0], st.ld_idx, st.ld_idx, ids,
                                         cfg.c_ld_non))
        if cfg.c_ld_hd:
            # HD neighbours: stable LD candidates unaffected by the motion
            parts.append(knn.sample_direct(r[1], st.hd_idx, cfg.c_ld_hd))
        if cfg.c_ld_rand:
            parts.append(knn.sample_uniform(r[2], n, n, cfg.c_ld_rand,
                                            device=ids.device))
        cand = torch.cat(parts, dim=1)
    cand_active = _take(st.active, cand)
    if use_kernel:
        new_idx, new_d, _ = ops.knn_merge(st.Y, ids, st.ld_idx, None, cand,
                                          cand_active=cand_active,
                                          cur_valid=cur_valid)
        return st._replace(ld_idx=new_idx, ld_d=new_d)
    valid = knn.dedup_candidates(ids, st.ld_idx, cand) & cand_active
    # re-score the current rows too: the embedding moved since the merge
    k = st.ld_idx.shape[1]
    if cfg.gather_fused:
        both = ops.pairwise_sqdist_gather(st.Y, ids,
                                          torch.cat([st.ld_idx, cand], dim=1))
        cur_d, cand_d = both[:, :k], both[:, k:]
    else:
        y_l = st.Y[ids.long()]
        cur_d = ((_take(st.Y, st.ld_idx) - y_l[:, None, :]) ** 2).sum(-1)
        cand_d = ((_take(st.Y, cand) - y_l[:, None, :]) ** 2).sum(-1)
    cur_d = torch.where(cur_valid, cur_d, torch.inf)
    new_idx, new_d, _ = knn.merge_knn(st.ld_idx, cur_d, cand, cand_d, valid)
    return st._replace(ld_idx=new_idx, ld_d=new_d)


def _forces_update(cfg: FuncSNEConfig, st: FuncSNEState, hp: HParams, rng,
                   ops: Ops):
    """Forces, the Z estimate and the gains/momentum update.

    The default path bins every edge in B3 (deterministic fixed point).
    With ``scatter_fused=False`` (B5) or ``gather_fused=False`` (B7) the
    kernels return per-edge forces and the symmetrisation is one segment
    sum over [rows, HD edges, LD edges], the JAX package's three
    ``.at[].add`` calls in their order; it adds each row's terms in that
    fixed order, so both paths repeat bit for bit on the card.
    """
    n, d = cfg.n_points, cfg.dim_ld
    ids = _ids(st)
    act_l = st.active
    n_act = st.active.float().sum().clamp_min(2.0)

    # attraction over the HD set: coef = p_{j|i} / (2N)  (Eq. 1)
    hd_valid = torch.isfinite(st.hd_d) & (st.hd_idx != SENTINEL)
    hd_valid &= _take(st.active, st.hd_idx)
    p = affinities.p_rows(st.hd_d, st.beta, valid=hd_valid)
    coef_a = torch.where(hd_valid & act_l[:, None], p, 0.0) / (2.0 * n_act)

    # repulsion over the LD set; 0.5 because each directed edge acts on
    # both endpoints
    ld_valid = (st.ld_idx != SENTINEL) & _take(st.active, st.ld_idx)
    coef_r = 0.5 * (ld_valid & act_l[:, None]).float()

    nbr = [st.hd_idx, st.ld_idx]
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
            neg = knn.sample_uniform(rng, n, n, cfg.n_negatives,
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
        # each directed edge also acts on its neighbour row
        tgt = [ids.long()] + [i.long().clamp(0, n - 1).reshape(-1)
                              for i in (st.hd_idx, st.ld_idx)]
        val = [agg_q] + [-(s * edge).reshape(-1, d)
                         for edge, s in ((edges[0], attr_s),
                                         (edges[1], rep_s))]
        buf = ops.segment_sum(torch.cat(tgt), torch.cat(val), n)
    dY = 4.0 * buf

    # t-SNE gains + momentum
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
                 ops: Ops = KERNELS) -> FuncSNEState:
    """One FUnc-SNE iteration (see the module docstring).

    ``ops`` selects the kernels (default) or the plain versions; the state
    and ``X`` stay on their device either way.
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
                        rev_due=step - rev_step >= cfg.rev_refresh)
    # The JAX step also requires any(new_flag); without a flag the refresh
    # changes nothing (beta is kept where no flag is set, and the cleared
    # flags are already clear), so that host sync is skipped here.
    if step % cfg.sigma_refresh_every == 0:
        st = _sigma_refresh(cfg, st, hp)
    st = _ld_refine(cfg, st, r_ld, ops)
    st = _forces_update(cfg, st, hp, r_force, ops)
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
                      n_iter=None, snapshot_every: int = 0):
    """``chunk(st, X, hp) -> (st, snapshots, ChunkMetrics)``: ``T`` steps.

    The counterpart of the JAX ``make_chunked_step``: the schedule is
    evaluated from the carried ``st.step``, the per-step scalars fold into
    :class:`ChunkMetrics` on the device, and ``snapshots`` is a device
    ring of ``T // snapshot_every + 1`` (n, d) slots (0 slots when
    ``snapshot_every`` is 0) that captures Y after every step whose new
    ``st.step`` is a multiple of ``snapshot_every``; the first
    ``metrics.n_snapshots`` slots are written.
    """
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if schedule is not None and n_iter is None:
        raise ValueError("schedule requires a static n_iter horizon")
    n, d = cfg.n_points, cfg.dim_ld
    n_snap = (T // snapshot_every + 1) if snapshot_every else 0
    decay = _METRICS_DECAY

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
            st = funcsne_step(cfg, st, X, hp_t)
            act_col = st.active[:, None].float()
            n_act = st.active.float().sum()
            act_disp = (st.vel.abs() * act_col).sum() \
                / (n_act.clamp_min(1.0) * d)
            disp = decay * disp + (1.0 - decay) * act_disp
            finite = torch.isfinite(st.Y)
            ff = (finite.float() * act_col).sum() / (n_act * d).clamp_min(1.0)
            ff = torch.where(n_act > 0, ff, 1.0)
            step_max = torch.where(finite & (act_col > 0), st.Y.abs(),
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
        return st, snaps, ChunkMetrics(
            step=st.step, n_snapshots=k, disp_ema=disp, zhat=st.zhat,
            ema_new_frac=st.ema_new_frac, finite_frac=ff_min, y_max_abs=ymax,
            bad_step=bad)

    return chunk


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


def fit(X, *, cfg: FuncSNEConfig = None, n_iter: int = 750, seed: int = 0,
        hparams: HParams = None, schedule=None, init: str = "pca",
        chunk_size: int = None, state: FuncSNEState = None,
        validate: bool = True, device="cuda", snapshot_every: int = 0,
        callback=None, early_stop=None, auto_rescale=None, resilience=None,
        resume_from=None):
    """Embed ``X``: ``init_state`` then chunks of ``chunk_size`` steps.

    Returns ``(state, snapshots)`` as the JAX ``fit``: ``snapshots`` is
    the list of numpy (n, d) copies of Y after every step whose count is
    a multiple of ``snapshot_every`` (empty when it is 0), drained from
    each chunk's ring.  ``callback``, ``early_stop``, ``auto_rescale``,
    ``resilience`` and ``resume_from`` are not ported yet and raise
    ``NotImplementedError``.
    """
    unported = {"callback": callback, "early_stop": early_stop,
                "auto_rescale": auto_rescale, "resilience": resilience,
                "resume_from": resume_from}
    given = [k for k, v in unported.items() if v]
    if given:
        raise NotImplementedError(f"fit options not ported yet: {given}")
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
        chunk_size = min(50, max(1, n_iter))
    st = state if state is not None else init_state(
        X, cfg, seed=seed, init=init, perplexity=hparams.perplexity,
        validate=False, device=dev)
    snapshots = []
    chunks = {}
    it = 0
    while it < n_iter:
        T = min(chunk_size, n_iter - it)
        if T not in chunks:
            chunks[T] = make_chunked_step(cfg, T, schedule=schedule,
                                          n_iter=n_iter,
                                          snapshot_every=snapshot_every)
        st, snaps, metrics = chunks[T](st, X, hparams)
        if snapshot_every:
            taken = int(metrics.n_snapshots)
            snapshots.extend(list(snaps[:taken].cpu().numpy()))
        it += T
    return st, snapshots
