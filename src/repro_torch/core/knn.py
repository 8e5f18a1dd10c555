"""Sampling and neighbour-list primitives (port of ``repro.core.knn``).

Neighbour sets are fixed-width sorted arrays (idx, d2) of shape (n, K),
ascending in d2; invalid slots hold (SENTINEL, +inf).

The counter hash reproduces the JAX package's int32 arithmetic bit for bit.
Torch has no logical right shift on int32 (``>>`` is arithmetic) and no
promise about signed-overflow wrapping, so the hash runs on int64 tensors
that hold the 32-bit pattern as a value in [0, 2^32): every shift is then
logical, and every product is split into 16-bit halves so that it stays
below 2^49 before it is masked back to 32 bits.  Public functions return
int32 tensors, as the JAX functions do.

The threefry samplers (``init_knn_idx``, ``sample_hops``,
``sample_direct``, ``sample_uniform`` and ``reverse_neighbors(fill_rng=)``)
draw through ``core.threefry``, so they reproduce ``jax.random`` exactly.
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry

SENTINEL = 2 ** 31 - 1  # invalid-slot index marker (int32 max)

_MASK = 0xFFFFFFFF
_MIX1 = 0x21f0aaad
_MIX2 = 0xd35a2d97
_KEY_ROW = 0x85ebca6b
_KEY_DRAW = 0xc2b2ae35
_POS_MASK = 0x7fffffff


def _u32(x) -> torch.Tensor:
    """Any int tensor, numpy array or Python int -> its 32-bit pattern as
    an int64 tensor in [0, 2^32)."""
    return torch.as_tensor(x).to(torch.int64) & _MASK


def _to_i32(u: torch.Tensor) -> torch.Tensor:
    """32-bit pattern held in int64 -> the int32 of the same bits."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a constant c in [0, 2^32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def _mix_u32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 15)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 15)


def _hash3_u32(salt, row, draw) -> torch.Tensor:
    h = _mix_u32(_u32(salt) ^ _mul32(_u32(row), _KEY_ROW))
    return _mix_u32(h ^ _mul32(_u32(draw), _KEY_DRAW))


def hash_mix(h) -> torch.Tensor:
    """lowbias32 finalizer on int32 bits (wrapping multiply semantics)."""
    return _to_i32(_mix_u32(_u32(h)))


def hash3(salt, row, draw) -> torch.Tensor:
    """Counter hash of ``(salt, row, draw)`` -> int32 uniform bits."""
    return _to_i32(_hash3_u32(salt, row, draw))


def counter_randint(salt, row, draw, bound) -> torch.Tensor:
    """Uniform int32 in [0, bound) from the counter hash (31-bit mod)."""
    return ((_hash3_u32(salt, row, draw) & _POS_MASK) % bound).to(torch.int32)


def counter_uniform01(h) -> torch.Tensor:
    """int32 hash bits -> f32 uniform in [0, 1) (top 24 bits, exact)."""
    return (_u32(h) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def key_salt(key_words) -> torch.Tensor:
    """Fold the raw words of a PRNG key into one int32 salt.

    ``key_words`` holds the uint32 words of ``jax.random.key_data(key)``
    (the port's state carries them as an int64 tensor of shape (2,)).
    """
    words = _u32(key_words).reshape(-1)
    salt = torch.zeros((), dtype=torch.int64, device=words.device)
    for i in range(words.shape[0]):
        salt = _mix_u32(salt ^ words[i])
    return _to_i32(salt)


def as_salt(key_or_salt) -> torch.Tensor:
    """A 0-dim int32 salt passes through; key words are folded."""
    x = torch.as_tensor(key_or_salt)
    if x.ndim == 0 and x.dtype == torch.int32:
        return x
    return key_salt(x)


def counter_candidates(salt, rows, sources, first_tables=(),
                       second_tables=(), n_total=None, extra=None):
    """Plain version of the candidate-fused sampler.

    Slot ``g`` of row ``r`` draws ``hash3(salt, rows[r], 2g)`` (the 'a'
    stream) and, for two-hop slots, ``hash3(salt, rows[r], 2g+1)`` (the
    'b' stream).  ``sources`` is the static layout grammar of
    ``repro.core.knn.counter_candidates``: ("uniform", c),
    ("one_hop", f, c), ("two_hop", f, s, c), ("extra", c).
    Returns the (B, C) int32 candidate block.
    """
    b = rows.shape[0]
    rows_c = rows.to(torch.int64)[:, None]
    dev = rows.device
    parts = []
    g = 0
    e0 = 0
    for src in sources:
        kind, c = src[0], src[-1]
        if c == 0:
            continue
        slots = g + torch.arange(c, dtype=torch.int64, device=dev)[None, :]
        if kind == "uniform":
            cand = counter_randint(salt, rows_c, 2 * slots, n_total)
        elif kind == "one_hop":
            f = first_tables[src[1]]
            a = counter_randint(salt, rows_c, 2 * slots, f.shape[1])
            cand = torch.gather(f, 1, a.long())
        elif kind == "two_hop":
            f = first_tables[src[1]]
            s = second_tables[src[2]]
            n2, k2 = s.shape
            a = counter_randint(salt, rows_c, 2 * slots, f.shape[1])
            mid = torch.gather(f, 1, a.long()).to(torch.int64)
            mid = torch.where(mid == SENTINEL, rows_c % n2, mid)
            mid = mid.clamp(0, n2 - 1)
            bb = counter_randint(salt, rows_c, 2 * slots + 1, k2)
            cand = s.reshape(-1)[mid * k2 + bb.long()]
        elif kind == "extra":
            cand = extra[:, e0:e0 + c]
            e0 += c
        else:
            raise ValueError(f"unknown candidate source {kind!r}")
        parts.append(cand.to(torch.int32))
        g += c
    if not parts:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    return torch.cat(parts, dim=1)


def counter_fill(salt, n: int, r: int) -> torch.Tensor:
    """(n, r) uniform fill table for ``reverse_neighbors`` (counter RNG):
    entry (i, j) is ``counter_randint(salt, i, j, n)``."""
    dev = torch.as_tensor(salt).device
    rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    draws = torch.arange(r, dtype=torch.int64, device=dev)[None, :]
    return counter_randint(salt, rows, draws, n)


def reverse_neighbors(idx, n_total: int, r: int, fill_rng=None, fill=None):
    """Up to ``r`` points that list each point as a neighbour.

    One stable sort over the n*K directed edges groups them by target; row
    i takes the first ``r`` sources of its group in source order, and the
    slots it cannot fill come from the same slots of a uniform table
    (n_total, r): ``fill`` itself (the counter-RNG path), or
    ``sample_uniform(fill_rng, n_total, n_total, r)`` (threefry).  Pass
    ``fill_rng`` xor ``fill``.  The counterpart of
    ``repro.core.knn.reverse_neighbors``: ``jnp.argsort`` is stable and
    ``jnp.searchsorted`` left-sided.  Returns (n_total, r) int32.
    """
    if (fill is None) == (fill_rng is None):
        raise ValueError("pass fill_rng xor fill")
    n, k = idx.shape
    dev = idx.device
    if fill is None:
        fill = sample_uniform(fill_rng, n_total, n_total, r, device=dev)
    tgt = idx.reshape(-1)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)
    tgt_s, order = torch.sort(tgt, stable=True)
    src_s = src[order]
    starts = torch.searchsorted(
        tgt_s, torch.arange(n_total, dtype=tgt_s.dtype, device=dev),
        right=False)
    ends = torch.cat([starts[1:], starts.new_full((1,), tgt_s.shape[0])])
    slot = torch.arange(r, dtype=starts.dtype, device=dev)[None, :]
    valid = slot < (ends - starts)[:, None]
    gathered = src_s[(starts[:, None] + slot).clamp(0, src_s.shape[0] - 1)]
    return torch.where(valid, gathered, fill.to(torch.int32))


def init_knn_idx(rng, n_rows: int, n_total: int, k: int,
                 row_offset: int = 0, device=None):
    """Random initial neighbour sets: (random base + 0..k-1) mod n.

    Distinct within a row and never the row itself.  The base is the
    threefry draw ``randint(rng, (n_rows, 1), 0, n_total)`` of the JAX
    package, made on ``device`` (default: the key's), so a key gives the
    JAX package's lists exactly.
    """
    if k > n_total - 1:
        raise ValueError(f"k={k} needs at least k+1 points, got {n_total}")
    base = threefry.randint(rng, (n_rows, 1), 0, n_total, device=device)
    dev = base.device
    rows = row_offset + torch.arange(n_rows, dtype=torch.int32,
                                     device=dev)[:, None]
    offs = 1 + (base + torch.arange(k, dtype=torch.int32, device=dev)[None, :]) \
        % (n_total - 1)
    return ((rows + offs) % n_total).to(torch.int32)


def sample_hops(rng, first_idx, second_idx, rows, n_samples: int):
    """Two-hop candidates ``second_idx[first_idx[i, a], b]`` for threefry
    draws (a, b).

    ``first_idx`` (n, K1) holds the local rows' lists, ``second_idx``
    (N, K2) the global table.  A SENTINEL mid becomes ``rows % N`` and the
    mid is clipped before the second gather, as in the JAX sampler.
    Returns (n, n_samples) int32.
    """
    n, k1 = first_idx.shape
    n2, k2 = second_idx.shape
    ra, rb = threefry.split(rng, 2)
    dev = first_idx.device
    a = threefry.randint(ra, (n, n_samples), 0, k1, device=dev)
    b = threefry.randint(rb, (n, n_samples), 0, k2, device=dev)
    mid = torch.gather(first_idx, 1, a.long())
    mid = torch.where(mid == SENTINEL, rows[:, None] % n2, mid)
    return second_idx[mid.long().clamp(0, n2 - 1), b.long()]


def sample_direct(rng, idx, n_samples: int):
    """One-hop candidates: threefry-drawn entries of the row's own list."""
    n, k = idx.shape
    a = threefry.randint(rng, (n, n_samples), 0, k, device=idx.device)
    return torch.gather(idx, 1, a.long())


def sample_uniform(rng, n: int, n_total: int, n_samples: int, device=None):
    """(n, n_samples) uniform int32 ids in [0, n_total) from threefry."""
    return threefry.randint(rng, (n, n_samples), 0, n_total, device=device)


def dedup_candidates(rows, cur_idx, cand_idx):
    """Mask of candidates that are not the row itself, not already in the
    list, not an earlier candidate of the row and not SENTINEL."""
    self_dup = cand_idx == rows[:, None]
    in_cur = (cand_idx[:, :, None] == cur_idx[:, None, :]).any(dim=-1)
    c = cand_idx.shape[1]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=cand_idx.device), diagonal=-1)
    earlier = cand_idx[:, :, None] == cand_idx[:, None, :]
    within = (earlier & tri[None]).any(dim=-1)
    sentinel = cand_idx == SENTINEL
    return ~(self_dup | in_cur | within | sentinel)


def merge_knn(cur_idx, cur_d, cand_idx, cand_d, valid_mask):
    """Merge candidates into the sorted K-NN arrays.

    A stable ascending sort over [current, candidates] keeps the K
    smallest with ``lax.top_k``'s tie rule (lower concatenation index
    first).  Returns (idx, d, row_improved).
    """
    k = cur_idx.shape[1]
    cand_d = torch.where(valid_mask, cand_d, torch.inf)
    all_idx = torch.cat([cur_idx, cand_idx], dim=1)
    all_d = torch.cat([cur_d, cand_d], dim=1)
    new_d, pos = torch.sort(all_d, dim=1, stable=True)
    new_idx = torch.gather(all_idx, 1, pos[:, :k])
    improved = (cand_d < cur_d[:, -1:]).any(dim=1)
    return new_idx, new_d[:, :k].contiguous(), improved


def exact_knn(X, k: int, active=None, rows=None):
    """Exact KNN by one matrix product per row chunk (ground truth).

    ``rows`` (default: all) are the query ids; every row of ``X`` is a
    candidate.  Ties keep the lower index first, as ``lax.top_k`` does.
    Returns (idx (R, k) int32, d2 (R, k) f32).
    """
    n = X.shape[0]
    if rows is None:
        rows = torch.arange(n, device=X.device)
    rows = rows.to(torch.int64)
    n2 = (X * X).sum(dim=1)
    chunk = max(1, 2 ** 26 // n)          # <= 256 MiB of f32 distances
    out_i, out_d = [], []
    for start in range(0, rows.shape[0], chunk):
        r = rows[start:start + chunk]
        d2 = n2[r, None] + n2[None, :] - 2.0 * (X[r] @ X.T)
        d2 = d2.clamp_min(0.0)
        d2[torch.arange(r.shape[0], device=X.device), r] = torch.inf
        if active is not None:
            d2 = torch.where(active[None, :], d2, torch.inf)
        d, i = torch.sort(d2, dim=1, stable=True)
        out_i.append(i[:, :k].to(torch.int32))
        out_d.append(d[:, :k])
    return torch.cat(out_i), torch.cat(out_d)
