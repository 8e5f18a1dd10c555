"""Causal GQA attention and MLA (port of ``repro.models.attention``:
``flash_chunked``, ``decode_attention``, ``init_gqa``, ``gqa_apply``,
``init_mla``, ``mla_apply``).

``flash_chunked`` takes the model's (B, S, H, D) layout, with values of
their own width Dv (MLA's 128 against its queries' and keys' 192).  On a
CUDA tensor it launches B8 (``kernels.flash_attention``: the tensor-core
kernel for bf16 at D = Dv 64, 80, 128 and 256 and at (192, 128), its 3xTF32
counterpart for float32 at D = Dv 64 and 128, the SIMT kernel otherwise)
through strides, with no transpose copy; on a CPU tensor it runs
``flash_chunked_ref``, the plain online softmax over KV chunks of the JAX
function, which also runs on the card as B8's plain version.  It goes
through ``FlashAttention``, an autograd Function whose backward is B8's
backward on the card (``csrc/flash_attention_bwd_wgmma.cu`` on the tensor
cores at the bf16 widths above, ``csrc/flash_attention_bwd.cu`` otherwise)
and its plain version ``flash_attention_bwd_ref`` on the CPU, so a loss
differentiates through attention on either device.

Decode (``gqa_apply`` with a cache) writes the new token's K and V into
the cache at ``cur_len - 1`` in place and attends over the cache with
``decode_attention``, plain PyTorch as in the JAX package (an einsum over
the cache, no Pallas kernel there).  ``cur_len`` is a 0-d integer tensor on
the model's device: the write index, RoPE's position and the masks are
tensors, so a step makes no host sync.

MLA (DeepSeek-V2) prefills in the non-absorbed form, per-head K and V
from the latent through ``flash_chunked`` (B8 at D 192, Dv 128 on the
card), and decodes in the absorbed form: the cache holds only the latent
and the shared RoPE key, written in place at ``cur_len - 1``, and the
scores contract the query folded through ``w_uk`` against the latent in
float32, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       matmul_cd, proj_heads, rms_norm)

_NEG = -1e30


def flash_chunked_ref(q, k, v, *, chunk_q: int = 0, chunk_k: int = 512,
                      scale: float, cap: float = 0.0, window: int = 0,
                      q_offset=0, score_budget_bytes: int = 192 * 2 ** 20,
                      seq_shards: int = 1):
    """Causal GQA attention: one online-softmax pass over KV chunks (the
    JAX ``flash_chunked``, line for line, on either device).

    q: (B, Sq, Hq, D); k: (B, Sk, Hkv, D); v: (B, Sk, Hkv, Dv).
    q_offset: global position of q[0].  Returns (B, Sq, Hq, Dv) in q's
    dtype; scores, running max, denominator and accumulator in float32.
    ``chunk_q`` is accepted and ignored, as in the JAX function.
    """
    del chunk_q
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    group = Hq // Hkv

    col_bytes = 4 * B * max(Sq // seq_shards, 1) * Hq
    ck = min(chunk_k, Sk)
    while ck > 128 and col_bytes * ck > score_budget_bytes:
        ck //= 2
    while Sk % ck:
        ck //= 2
    nk = Sk // ck

    qg = q.reshape(B, Sq, Hkv, group, D).float()
    rows = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Sq, Hkv, group), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hkv, group), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, group, Dv), dtype=torch.float32,
                      device=q.device)
    for ik in range(nk):
        kc = k[:, ik * ck:(ik + 1) * ck].float()        # (B, ck, Hkv, D)
        vc = v[:, ik * ck:(ik + 1) * ck].float()
        cols = ik * ck + torch.arange(ck, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kc) * scale
        if cap:
            s = cap * torch.tanh(s / cap)
        mask = cols[None, :] <= rows[:, None]
        if window:
            mask &= cols[None, :] > rows[:, None] - window
        s = torch.where(mask[None, :, None, None, :], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(m_new[..., None] > _NEG / 2, p, 0.0)
        corr = torch.where(m > _NEG / 2, torch.exp(m - m_new), 0.0)
        l = corr * l + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, Hq, Dv).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention with its gradient, in the model's (B, S, H, D)
    layout: ``FlashAttention.apply(q, k, v, kw, save)``.

    Forward: B8 on the card (the kernel ``kernel_route`` names, through
    strides) and ``flash_chunked_ref(q, k, v, **kw)`` on the CPU.
    Backward: B8's backward on the card (``launch_bwd``: the tensor-core
    kernel for bf16 at B8's tensor-core widths, the SIMT kernel otherwise,
    as ``bwd_route`` names) and its plain version
    ``flash_attention_bwd_ref`` on the CPU, from the saved q, k, v and
    output.  ``save`` (grad mode on and an input that requires
    grad, decided by the caller: inside ``forward`` grad mode is off) keeps
    those four for the backward; without it nothing is kept, and a call
    under ``no_grad`` or ``inference_mode`` runs exactly the forward's
    launch."""

    @staticmethod
    def forward(ctx, q, k, v, kw, save):
        if _build.kernel_device(q, k, v) == "cpu":
            out = flash_chunked_ref(q, k, v, **kw)
        else:
            B, S, Hq, _ = q.shape
            out = torch.empty((B, S, Hq, v.shape[-1]), dtype=q.dtype,
                              device=q.device)
            flash_ops.launch(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), out.transpose(1, 2),
                             scale=kw["scale"], softcap=kw["cap"],
                             window=kw["window"])
        if save:
            ctx.save_for_backward(q, k, v, out)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        # autograd may hand over any strides: copy only a dout that the
        # kernels cannot read (a non-unit last stride, or one TMA cannot
        # read), so that the model's own (B, S, H, D) views go through
        if dout.stride(-1) != 1 or not flash_ops.tma_readable(
                dout.transpose(1, 2)):
            dout = dout.contiguous()
        args = [t.transpose(1, 2) for t in (q, k, v, out, dout)]
        kw = dict(scale=ctx.kw["scale"], softcap=ctx.kw["cap"],
                  window=ctx.kw["window"])
        if _build.kernel_device(q, k, v) == "cpu":
            grads = flash_attention_bwd_ref(*args, **kw)
        else:
            grads = flash_ops.launch_bwd(*args, **kw)
        dq, dk, dv = (g.transpose(1, 2) for g in grads)
        return dq, dk, dv, None, None


def flash_chunked(q, k, v, *, chunk_q: int = 0, chunk_k: int = 512,
                  scale: float, cap: float = 0.0, window: int = 0,
                  q_offset=0, score_budget_bytes: int = 192 * 2 ** 20,
                  seq_shards: int = 1):
    """Causal GQA attention in the (B, S, H, D) layout, values (B, S, Hkv,
    Dv), through ``FlashAttention``: B8 and its backward kernel on the
    card, ``flash_chunked_ref`` and ``flash_attention_bwd_ref`` on the CPU
    (arguments as ``flash_chunked_ref``).  B8 takes self-attention only: a
    nonzero ``q_offset`` raises ``NotImplementedError`` on the card (on the
    CPU it runs ``flash_chunked_ref`` itself, differentiated by autograd),
    and a (D, Dv) that no kernel of B8 takes raises ``ValueError`` before
    any launch."""
    kw = dict(chunk_q=chunk_q, chunk_k=chunk_k, scale=scale, cap=cap,
              window=window, q_offset=q_offset,
              score_budget_bytes=score_budget_bytes, seq_shards=seq_shards)
    offset = (torch.is_tensor(q_offset) or q_offset != 0
              or k.shape[1] != q.shape[1])
    if offset:
        if _build.kernel_device(q, k, v) == "cpu":
            return flash_chunked_ref(q, k, v, **kw)
        raise NotImplementedError("B8 takes causal self-attention from "
                                  "position 0 (q_offset = 0, Sq == Sk)")
    save = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    return FlashAttention.apply(q, k, v, kw, save)


def decode_attention(q, k_cache, v_cache, cur_len, *, scale: float,
                     cap: float = 0.0, window: int = 0):
    """One-token attention over a (B, Smax, Hkv, D) cache.

    q: (B, 1, Hq, D); cur_len: current length *including* the new token (a
    0-d tensor, or (B, 1) for one length a row).  Scores, softmax and sum in
    float32, softcap before the mask; returns (B, 1, Hq, D) in q's dtype.
    """
    B, Smax, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    pos = torch.arange(Smax, device=q.device)[None, :]
    mask = pos < cur_len
    if window:
        mask &= pos > cur_len - 1 - window
    s = torch.where(mask[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# --------------------------------------------------------------------------
# GQA attention layer


def init_gqa(key, cfg, *, device=None):
    D, H, Hkv, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    dt = dtype_of(cfg.param_dtype)
    ks = threefry.split(key, 4)
    p = {
        "wq": dense_init(ks[0], (D, H, Dh), dt, fan_in=D, device=device),
        "wk": dense_init(ks[1], (D, Hkv, Dh), dt, fan_in=D, device=device),
        "wv": dense_init(ks[2], (D, Hkv, Dh), dt, fan_in=D, device=device),
        "wo": dense_init(ks[3], (H, Dh, D), dt, fan_in=H * Dh, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, Dh), dtype=dt, device=device)
        p["bk"] = torch.zeros((Hkv, Dh), dtype=dt, device=device)
        p["bv"] = torch.zeros((Hkv, Dh), dtype=dt, device=device)
    return p


def cache_slot(cur_len, smax: int):
    """The cache slot a decode step writes: ``cur_len - 1`` clamped to
    [0, smax - 1] (as ``dynamic_update_slice`` clamps), a (1,) int64
    tensor on cur_len's device for ``index_copy_``; no host sync."""
    return (cur_len - 1).reshape(1).clamp(0, smax - 1).long()


def _default_positions(h, cur_len):
    """(1, S) prefill positions, or (B, 1) at ``cur_len - 1`` in decode."""
    B, S = h.shape[:2]
    if cur_len is None:
        return torch.arange(S, device=h.device)[None, :]
    return (cur_len - 1) * torch.ones((B, 1), dtype=torch.int32,
                                      device=h.device)


def gqa_apply(p, h, cfg, *, window: int = 0, positions=None, cache=None,
              cur_len=None, attention=flash_chunked):
    """h: (B, S, D) -> ((B, S, D), new_cache).

    Without a cache: prefill attention through ``attention``
    (``flash_chunked``, B8 on the card, or ``flash_chunked_ref``); the
    cache returned is None.  With ``cache`` (dict ``k``, ``v`` of shape
    (B, Smax, Hkv, Dh)) and ``cur_len``: one decode token (S = 1), written
    into the cache in place at ``cur_len - 1`` clamped to [0, Smax - 1] (as
    ``dynamic_update_slice`` clamps), then ``decode_attention``; the cache
    dict is returned.
    """
    B, S, D = h.shape
    Dh = cfg.resolved_head_dim
    cd = dtype_of(cfg.compute_dtype)
    h = h.to(cd)
    q = proj_heads(h, p["wq"], cd)
    k = proj_heads(h, p["wk"], cd)
    v = proj_heads(h, p["wv"], cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if positions is None:
        positions = _default_positions(h, cur_len)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = Dh ** -0.5

    if cache is None:
        out = attention(q, k, v, chunk_k=min(cfg.attn_chunk_k, S),
                        scale=scale, cap=cfg.attn_softcap, window=window)
    else:
        idx = cache_slot(cur_len, cache["k"].shape[1])
        cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
        out = decode_attention(q, cache["k"], cache["v"], cur_len,
                               scale=scale, cap=cfg.attn_softcap,
                               window=window)
    wo = p["wo"].to(cd)
    out = matmul_cd(out.to(cd).reshape(B, S, -1), wo.reshape(-1, wo.shape[-1]))
    return out, cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-compressed KV with a decoupled RoPE head


def init_mla(key, cfg, *, device=None):
    D, H = cfg.d_model, cfg.n_heads
    L, dn, dr, dv = (cfg.kv_lora_rank, cfg.q_nope_dim, cfg.q_rope_dim,
                     cfg.v_head_dim)
    dt = dtype_of(cfg.param_dtype)
    ks = threefry.split(key, 5)
    return {
        "wq": dense_init(ks[0], (D, H, dn + dr), dt, fan_in=D, device=device),
        "w_dkv": dense_init(ks[1], (D, L + dr), dt, fan_in=D, device=device),
        "kv_norm": torch.zeros((L,), dtype=dt, device=device) + 1.0,
        "w_uk": dense_init(ks[2], (L, H, dn), dt, fan_in=L, device=device),
        "w_uv": dense_init(ks[3], (L, H, dv), dt, fan_in=L, device=device),
        "wo": dense_init(ks[4], (H, dv, D), dt, fan_in=H * dv, device=device),
    }


def _per_head(x, w, cd):
    """x (B, S, H, n) against w (H, n, m), one product a head in the
    compute dtype: (B, S, H, m)."""
    B, S, H, n = x.shape
    out = matmul_cd(x.to(cd).permute(2, 0, 1, 3).reshape(H, B * S, n),
                    w.to(cd))                               # (H, B S, m)
    return out.reshape(H, B, S, -1).permute(1, 2, 0, 3)


def mla_apply(p, h, cfg, *, positions=None, cache=None, cur_len=None,
              window: int = 0, attention=flash_chunked):
    """h: (B, S, D) -> ((B, S, D), new_cache).

    Without a cache: the non-absorbed form, per-head K (``w_uk``'s 128
    columns and the shared RoPE key's 64) and V (``w_uv``'s 128) from the
    latent through ``attention`` (B8 at D 192, Dv 128 on the card).  With
    ``cache`` (dict ``latent`` (B, Smax, L), ``k_rope`` (B, Smax, dr)) and
    ``cur_len``: one decode token in the absorbed form, the latent pair
    written in place at ``cur_len - 1`` clamped, scores of the query
    folded through ``w_uk`` against the latent in float32; the cache dict
    is returned.
    """
    B, S, D = h.shape
    L, dn, dr = cfg.kv_lora_rank, cfg.q_nope_dim, cfg.q_rope_dim
    cd = dtype_of(cfg.compute_dtype)
    h = h.to(cd)
    if positions is None:
        positions = _default_positions(h, cur_len)

    q = proj_heads(h, p["wq"], cd)                          # (B, S, H, dn+dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = matmul_cd(h, p["w_dkv"].to(cd))                   # (B, S, L+dr)
    latent = rms_norm(ckv[..., :L], p["kv_norm"])
    k_rope = apply_rope(ckv[..., L:], positions, cfg.rope_theta)  # (B,S,dr)
    scale = (dn + dr) ** -0.5
    wo = p["wo"].to(cd)

    if cache is not None:
        # einsum('bshn,lhn->bshl'): the query folded through w_uk
        q_eff = _per_head(q_nope, p["w_uk"].permute(1, 2, 0), cd)
        idx = cache_slot(cur_len, cache["latent"].shape[1])
        cache["latent"].index_copy_(1, idx,
                                    latent.to(cache["latent"].dtype))
        cache["k_rope"].index_copy_(1, idx,
                                    k_rope.to(cache["k_rope"].dtype))
        lat = cache["latent"].float()
        s = (torch.einsum("bshl,btl->bhst", q_eff.float(), lat)
             + torch.einsum("bshr,btr->bhst", q_rope.float(),
                            cache["k_rope"].float())) * scale
        pos = torch.arange(lat.shape[1], device=h.device)[None, :]
        s = torch.where((pos < cur_len)[:, None, None, :], s, _NEG)
        w = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhst,btl->bshl", w, lat)      # (B, S, H, L)
        out = _per_head(o_lat, p["w_uv"].permute(1, 0, 2), cd)  # (B,S,H,dv)
        return matmul_cd(out.reshape(B, S, -1), wo.reshape(-1, D)), cache

    k_nope = proj_heads(latent, p["w_uk"], cd)              # (B, S, H, dn)
    v = proj_heads(latent, p["w_uv"], cd)                   # (B, S, H, dv)
    H = k_nope.shape[2]
    kcat = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                     dim=-1)
    qcat = torch.cat([q_nope, q_rope], dim=-1)
    o = attention(qcat, kcat, v, chunk_k=min(cfg.attn_chunk_k, S),
                  scale=scale, cap=0.0, window=window)
    return matmul_cd(o.reshape(B, S, -1), wo.reshape(-1, D)), None
