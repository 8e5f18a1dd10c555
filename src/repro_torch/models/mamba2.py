"""Mamba2 mixer via SSD, state-space duality (port of
``repro.models.mamba2``: ``init_mamba2``, ``_causal_conv_hp``,
``_ssd_chunk_scan``, ``ssd_reference``, ``_gated_norm``,
``mamba2_apply``).

Prefill runs the chunked SSD algorithm as a loop over sequence chunks:
within a chunk the recurrence is the quadratic masked-decay form, (Q x Q)
products a head; across chunks only the (B, H, N, P) state is carried, in
float32.  ``ssd_reference`` is the O(S) recurrence, the oracle of the
tests.  Decode carries the causal conv's last K - 1 inputs (in the
cache's dtype) and the SSM state (float32), O(1) a token, and writes both
into the cache in place.

The JAX package has no Pallas kernel here, so neither has the port: this
module is plain PyTorch on both devices.  Every d_inner tensor keeps the
reference's (H, P) head-feature form (projections (D, H, P), the conv per
(H, P) channel).  ``mamba2_specs`` and the ``shard_map`` of the chunk
scan (the reference's sharding plumbing) are not ported: the port runs
one device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import threefry
from repro_torch.models.common import (dense_init, dtype_of, matmul_cd,
                                       proj_heads)


def _log32(x: float) -> float:
    """log(x) in float32, as ``jnp.log`` of a Python float."""
    return float(torch.log(torch.tensor(x, dtype=torch.float32)))


def init_mamba2(key, cfg, *, device=None):
    D = cfg.d_model
    N, H, Pd = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    G = cfg.ssm_ngroups
    dt = dtype_of(cfg.param_dtype)
    ks = threefry.split(key, 8)
    dt_init = torch.exp(threefry.uniform(ks[6], (H,), _log32(0.001),
                                         _log32(0.1), device=device))
    return {
        "w_z": dense_init(ks[0], (D, H, Pd), dt, fan_in=D, device=device),
        "w_x": dense_init(ks[1], (D, H, Pd), dt, fan_in=D, device=device),
        "w_B": dense_init(ks[2], (D, G * N), dt, fan_in=D, device=device),
        "w_C": dense_init(ks[3], (D, G * N), dt, fan_in=D, device=device),
        "w_dt": dense_init(ks[4], (D, H), dt, fan_in=D, device=device),
        "conv_x": dense_init(ks[5], (cfg.ssm_conv, H, Pd), dt,
                             fan_in=cfg.ssm_conv, device=device),
        "A_log": torch.log(threefry.uniform(ks[7], (H,), 1.0, 16.0,
                                            device=device)),
        "dt_bias": dt_init + torch.log(-torch.expm1(-dt_init)),
        "D_skip": torch.ones((H,), dtype=torch.float32, device=device),
        "norm": torch.ones((H, Pd), dtype=dt, device=device),
        "w_out": dense_init(threefry.fold_in(ks[0], 9), (H, Pd, D), dt,
                            fan_in=H * Pd, device=device),
    }


def _causal_conv_hp(x, w, state=None):
    """Depthwise causal conv along S on (B, S, H, P) channels; w: (K, H, P).

    state: (B, K-1, H, P) previous inputs for decode.  Returns the conv's
    output and the last K - 1 inputs (the next step's state).
    """
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S+K-1, H, P)
    S = x.shape[1]
    y = 0
    for i in range(K):                              # the reference's order
        y = y + xp[:, i:i + S] * w[i][None, None]
    return y, xp[:, -(K - 1):]


def _ssd_chunk_scan(xh, dt, A, Bm, Cm, Dsk, chunk: int):
    """Chunked SSD.  xh: (B, S, H, P); dt: (B, S, H); A, Dsk: (H,);
    Bm / Cm: (B, S, N) (one group).  S must be a multiple of ``chunk``.
    Returns y (B, S, H, P) in float32 (the skip term included)."""
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"S = {S} is not a multiple of the chunk {chunk}")
    nc, Q = S // chunk, chunk
    xc = xh.float().reshape(Bsz, nc, Q, H, Pd)
    dtc = dt.float().reshape(Bsz, nc, Q, H)
    Bc = Bm.float().reshape(Bsz, nc, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, Q, N)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    h = torch.zeros((Bsz, H, N, Pd), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        x, d, b, cm = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        a = d * A[None, None, :]                    # (B, Q, H) negative
        cums = torch.cumsum(a, dim=1)               # inclusive
        # intra-chunk: the masked decay matrix of each head
        dec = cums[:, :, None, :] - cums[:, None, :, :]     # (B, Q, Q, H)
        dec = torch.where(tri[None, :, :, None], dec, -torch.inf)
        M = torch.einsum("bqn,bkn->bqk", cm, b)[..., None] * torch.exp(dec)
        xdt = x * d[..., None]                      # (B, Q, H, P)
        y = torch.einsum("bqkh,bkhp->bqhp", M, xdt)
        # inter-chunk: the incoming state's contribution
        y = y + torch.einsum("bqn,bhnp->bqhp", cm, h) \
            * torch.exp(cums)[..., None]
        # the state at the chunk's end
        decay_to_end = torch.exp(cums[:, -1:, :] - cums)    # (B, Q, H)
        s_new = torch.einsum("bkn,bkhp->bhnp", b,
                             xdt * decay_to_end[..., None])
        h = h * torch.exp(cums[:, -1, :])[:, :, None, None] + s_new
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, Pd)
    return y + xh.float() * Dsk[None, None, :, None]


def _state_decay(dt, A):
    """exp(dt * A): how much of the SSM state one step keeps, (B, H)."""
    return torch.exp(dt * A[None, :])


def ssd_reference(xh, dt, A, Bm, Cm, Dsk):
    """The O(S) recurrence (the oracle of the tests): same inputs and
    result as ``_ssd_chunk_scan``."""
    Bsz, S, H, Pd = xh.shape
    h = torch.zeros((Bsz, H, Bm.shape[-1], Pd), dtype=torch.float32,
                    device=xh.device)
    ys = []
    for t in range(S):
        x, d = xh[:, t].float(), dt[:, t].float()
        b, c = Bm[:, t].float(), Cm[:, t].float()
        h = h * _state_decay(d, A)[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", b, x * d[..., None])
        ys.append(torch.einsum("bn,bhnp->bhp", c, h))
    y = torch.stack(ys, dim=1)
    return y + xh.float() * Dsk[None, None, :, None]


def _gated_norm(y, z, scale, eps: float = 1e-6):
    """RMSNormGated over the flattened (H, P) feature dims, in float32."""
    y32 = y.float() * F.silu(z.float())
    var = (y32 * y32).mean(dim=(-2, -1), keepdim=True)
    return y32 * torch.rsqrt(var + eps) * scale.float()


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def mamba2_apply(p, h, cfg, *, cache=None, use_reference=False):
    """h: (B, S, D) -> (out (B, S, D), cache).

    Without a cache: prefill through ``_ssd_chunk_scan`` at chunk
    min(ssm_chunk, S) (``ssd_reference`` with ``use_reference``); the
    cache returned is None.  With ``cache`` (dict ``conv`` (B, K-1, H, P),
    ``ssm`` (B, H, N, P) float32): one decode token (S = 1), the new conv
    inputs and SSM state written into the cache in place; the cache dict
    is returned.
    """
    B, S, D = h.shape
    cd = dtype_of(cfg.compute_dtype)
    h = h.to(cd)
    z = proj_heads(h, p["w_z"], cd)
    x = proj_heads(h, p["w_x"], cd)
    Bm = matmul_cd(h, p["w_B"].to(cd))
    Cm = matmul_cd(h, p["w_C"].to(cd))
    dt_raw = matmul_cd(h, p["w_dt"].to(cd))
    # the layer boundary is crossed in the compute dtype, as the reference
    dt = _softplus(dt_raw.float() + p["dt_bias"][None, None, :]).to(cd)
    A = -torch.exp(p["A_log"])

    if cache is None:
        x, _ = _causal_conv_hp(x, p["conv_x"].to(cd))
        xh = F.silu(x.float()).to(cd)
        if use_reference:
            y = ssd_reference(xh, dt, A, Bm, Cm, p["D_skip"])
        else:
            y = _ssd_chunk_scan(xh, dt, A, Bm, Cm, p["D_skip"],
                                chunk=min(cfg.ssm_chunk, S))
    else:
        xconv, conv_state = _causal_conv_hp(x, p["conv_x"].to(cd),
                                            state=cache["conv"])
        xh = F.silu(xconv.float()).to(cd)
        ssm = cache["ssm"] * _state_decay(dt[:, 0], A)[:, :, None, None] \
            + torch.einsum("bn,bhp->bhnp", Bm[:, 0].float(),
                           xh[:, 0].float() * dt[:, 0, :, None])
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), ssm)
        y = (y + xh[:, 0].float() * p["D_skip"][None, :, None])[:, None]
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(ssm)

    y = _gated_norm(y, z, p["norm"]).to(cd)                 # (B, S, H, P)
    w_out = p["w_out"].to(cd)
    out = matmul_cd(y.reshape(B, S, -1), w_out.reshape(-1, D))
    return out, cache
