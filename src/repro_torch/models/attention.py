"""Causal GQA attention for the prefill/forward path (port of
``repro.models.attention``: ``flash_chunked``, ``init_gqa``,
``gqa_apply`` without a cache).

``flash_chunked`` takes the model's (B, S, H, D) layout.  On a CUDA tensor
it launches B8 (``kernels.flash_attention``, a hand-written CUDA kernel)
through strides, with no transpose copy; on a CPU tensor it runs
``flash_chunked_ref``, the plain online softmax over KV chunks of the JAX
function, which also runs on the card as B8's plain version.

Not ported yet (ROADMAP A8): ``decode_attention`` and the decode branch of
``gqa_apply`` (the KV cache), MLA (``init_mla``, ``mla_apply``).
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import apply_rope, dense_init, dtype_of

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


def flash_chunked(q, k, v, *, chunk_q: int = 0, chunk_k: int = 512,
                  scale: float, cap: float = 0.0, window: int = 0,
                  q_offset=0, score_budget_bytes: int = 192 * 2 ** 20,
                  seq_shards: int = 1):
    """Causal GQA attention in the (B, S, H, D) layout: B8 on the card,
    ``flash_chunked_ref`` on the CPU (arguments as there).  B8 takes
    self-attention only: ``Dv != D`` (MLA) and a nonzero ``q_offset``
    raise ``NotImplementedError`` on the card."""
    if _build.kernel_device(q, k, v) == "cpu":
        return flash_chunked_ref(
            q, k, v, chunk_q=chunk_q, chunk_k=chunk_k, scale=scale, cap=cap,
            window=window, q_offset=q_offset,
            score_budget_bytes=score_budget_bytes, seq_shards=seq_shards)
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError("B8 takes Dv == D only (MLA's latent "
                                  "values are not ported)")
    if (torch.is_tensor(q_offset) or q_offset != 0) or k.shape[1] != q.shape[1]:
        raise NotImplementedError("B8 takes causal self-attention from "
                                  "position 0 (q_offset = 0, Sq == Sk)")
    B, S, Hq, D = q.shape
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    flash_ops.launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     out.transpose(1, 2), scale=scale, softcap=cap,
                     window=window)
    return out


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


def _proj(h, w, cd):
    """einsum('bsd,dhk->bshk') as one matmul in the compute dtype."""
    D = w.shape[0]
    return (h @ w.to(cd).reshape(D, -1)).reshape(*h.shape[:2], *w.shape[1:])


def gqa_apply(p, h, cfg, *, window: int = 0, positions=None, cache=None,
              cur_len=None, attention=flash_chunked):
    """h: (B, S, D) -> ((B, S, D), None): prefill attention.  ``attention``
    is ``flash_chunked`` (B8 on the card) or ``flash_chunked_ref``."""
    if cache is not None or cur_len is not None:
        raise NotImplementedError("decode attention (the KV cache) is not "
                                  "ported yet")
    B, S, D = h.shape
    Dh = cfg.resolved_head_dim
    cd = dtype_of(cfg.compute_dtype)
    h = h.to(cd)
    q = _proj(h, p["wq"], cd)
    k = _proj(h, p["wk"], cd)
    v = _proj(h, p["wv"], cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if positions is None:
        positions = torch.arange(S, device=h.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, chunk_k=min(cfg.attn_chunk_k, S),
                    scale=Dh ** -0.5, cap=cfg.attn_softcap, window=window)
    wo = p["wo"].to(cd)
    out = out.to(cd).reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return out, None
