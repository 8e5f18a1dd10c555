"""Nearest-neighbour descent baseline (Dong et al., 2011); port of
``repro.core.nnd``.

Greedy iterative KNN-graph refinement: candidates come from the local join
(neighbours-of-neighbours through forward and reverse edges), with no
embedding feedback and no random probes.  It shares the merge machinery of
FUnc-SNE's KNN search, so the comparison isolates the candidate policy.

The draws are the JAX package's: threefry (``core.threefry``) by default,
or the counter hash with ``cand_fused=True``, so ``nnd_init``,
``nnd_step`` and ``nnd`` give the JAX lists and update history exactly.
Kernels: B1 scores the initial lists (B6 with ``gather_fused=False``); an
iteration merges through B4 on the threefry candidate block, through B2
with ``cand_fused=True``, or through B1/B6 and the plain dedup/merge with
``merge_fused=False``.  The key chain (``fold_in``, ``split``) runs on the
host; the update fraction read per iteration is the one host sync.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import knn
from repro_torch.core import threefry
from repro_torch.core.funcsne import KERNELS, Ops, resolve_device


@dataclasses.dataclass(frozen=True)
class NNDConfig:
    """Fields and defaults of the JAX ``NNDConfig`` (no ``backend``: the
    tensors' device picks the kernels)."""
    k: int = 32
    c_fwd: int = 8          # forward neighbours-of-neighbours per iteration
    c_rev: int = 4          # reverse-edge hops per iteration
    gather_fused: bool = True
    merge_fused: bool = True
    cand_fused: bool = False
    rev_refresh: int = 1    # iterations between reverse-table rebuilds


def _key(rng):
    return threefry.prng_key(0) if rng is None else torch.as_tensor(rng)


def _mean(improved):
    """The update fraction as the JAX step computes ``jnp.mean``: XLA
    multiplies the count by the float32 reciprocal of n."""
    return improved.float().sum() * float(np.float32(1.0 / improved.numel()))


def _cand_sqdist(X, ids, cand, cfg: NNDConfig, ops: Ops):
    if cfg.gather_fused:
        return ops.pairwise_sqdist_gather(X, ids, cand)
    return ops.pairwise_sqdist(X[ids.long()],
                               X[cand.long().clamp(0, X.shape[0] - 1)])


def nnd_init(rng, X, cfg: NNDConfig, *, device="cuda", ops: Ops = KERNELS):
    """Random initial lists (threefry ``init_knn_idx``) scored and sorted
    with a stable sort.  Returns (idx (n, k) int32, d (n, k) f32)."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
    n = X.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    idx = knn.init_knn_idx(_key(rng), n, n, cfg.k, device=dev)
    d = _cand_sqdist(X, ids, idx, cfg, ops)
    d, order = torch.sort(d, dim=1, stable=True)
    return torch.gather(idx, 1, order), d


def nnd_step(rng, X, idx, d, cfg: NNDConfig, rev=None, *, device="cuda",
             ops: Ops = KERNELS):
    """One NND iteration; returns (idx, d, update_fraction).

    ``rev`` is the cached (n, c_rev) reverse-edge table; ``None`` rebuilds
    it in the step from ``split(rng, 3)[1]``, as the JAX step does.
    ``update_fraction`` is a 0-dim tensor on the device.
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
    idx, d = idx.to(dev), d.to(dev)
    n = X.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    r1, r2, r3 = threefry.split(_key(rng), 3)
    if cfg.c_rev and rev is None:
        rev = knn.reverse_neighbors(idx, n, cfg.c_rev, fill_rng=r2)
    use_kernel = cfg.merge_fused and cfg.gather_fused
    if cfg.cand_fused:
        # counter-RNG forward hops and rev-of-fwd hops; the cached reverse
        # edges ride in as "extra" slots.  The salt is folded on the host
        # and filled on the device (a host-to-device copy would sync)
        salt = torch.full((), int(knn.key_salt(r1)), dtype=torch.int32,
                          device=dev)
        sources = (("two_hop", 0, 0, cfg.c_fwd),)
        firsts = (idx,)
        if cfg.c_rev:
            sources += (("extra", cfg.c_rev), ("two_hop", 1, 0, cfg.c_rev))
            firsts += (rev,)
        extra = rev if cfg.c_rev else None
        if use_kernel:
            idx, d, improved = ops.knn_merge_cand(
                X, ids, idx, d, salt=salt, sources=sources,
                first_tables=firsts, second_tables=(idx,), extra=extra)
            return idx, d, _mean(improved)
        cand = knn.counter_candidates(salt, ids, sources, firsts, (idx,),
                                      n_total=n, extra=extra)
    else:
        parts = [knn.sample_hops(r1, idx, idx, ids, cfg.c_fwd)]
        if cfg.c_rev:
            # hop once through a reverse edge (rev-of-fwd closes the join)
            parts += [rev, knn.sample_hops(r3, rev, idx, ids, cfg.c_rev)]
        cand = torch.cat(parts, dim=1)
    if use_kernel:
        idx, d, improved = ops.knn_merge(X, ids, idx, d, cand)
    else:
        valid = knn.dedup_candidates(ids, idx, cand)
        cand_d = _cand_sqdist(X, ids, cand, cfg, ops)
        idx, d, improved = knn.merge_knn(idx, d, cand, cand_d, valid)
    return idx, d, _mean(improved)


def nnd(X, cfg: NNDConfig = NNDConfig(), rng=None, max_iter: int = 40,
        tol: float = 1e-3, *, device="cuda", ops: Ops = KERNELS):
    """Run NND until the update fraction drops below ``tol`` or for
    ``max_iter`` iterations; returns (idx, d, history).

    Iteration ``it`` draws from ``fold_in(rng, it)`` (``rng=None``:
    ``PRNGKey(0)``).  With ``rev_refresh > 1`` the reverse table is cached
    and rebuilt every ``rev_refresh`` iterations from the fill key the
    in-step rebuild would use, ``split(fold_in(rng, it), 3)[1]``.
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
    rng = _key(rng)
    n = X.shape[0]
    idx, d = nnd_init(rng, X, cfg, device=dev, ops=ops)
    cache = cfg.c_rev > 0 and cfg.rev_refresh > 1
    history = []
    rev = None
    for it in range(max_iter):
        r_it = threefry.fold_in(rng, it)
        if cache and it % cfg.rev_refresh == 0:
            rev = knn.reverse_neighbors(idx, n, cfg.c_rev,
                                        fill_rng=threefry.split(r_it, 3)[1])
        idx, d, frac = nnd_step(r_it, X, idx, d, cfg, rev=rev, device=dev,
                                ops=ops)
        history.append(float(frac))
        if history[-1] < tol:
            break
    return idx, d, history
