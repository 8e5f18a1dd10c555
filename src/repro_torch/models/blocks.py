"""Transformer blocks (port of ``repro.models.blocks``: the dense GQA
block, the Gemma2 pair, the MoE block with GQA or MLA attention, the
Mamba2 block and Zamba2's super-block).

A block apply returns ``(h_new, new_cache, aux)`` as in the JAX package;
``aux`` carries the MoE router losses (0-d float32 tensors), and the
dense and Gemma2 blocks return ``ZERO_AUX``'s zeros as Python floats.
With a cache (one decode token) ``new_cache`` is the cache written in
place; without one it is None.  Parameters are one dict per layer (the
JAX package stacks them), and a Zamba2 super-block holds a list of its
``shared_attn_every`` Mamba2 blocks (the JAX package stacks those too).
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (dense_init, dtype_of, gelu, matmul_cd,
                                       rms_norm, swiglu)

ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0, "dropped_frac": 0.0}


def init_mlp(key, cfg, d_ff=None, *, device=None):
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    ks = threefry.split(key, 3)
    return {"w_gate": dense_init(ks[0], (D, F), dt, fan_in=D, device=device),
            "w_up": dense_init(ks[1], (D, F), dt, fan_in=D, device=device),
            "w_down": dense_init(ks[2], (F, D), dt, fan_in=F, device=device)}


def mlp_apply(p, x, cfg):
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    g = matmul_cd(x, p["w_gate"].to(cd))
    u = matmul_cd(x, p["w_up"].to(cd))
    h = gelu(g) * u if cfg.mlp_act == "geglu" else swiglu(g, u)
    return matmul_cd(h, p["w_down"].to(cd))


def _norm(p, x, cfg):
    return rms_norm(x, p, plus_one=cfg.norm_plus_one)


def init_dense_block(key, cfg, *, device=None):
    ks = threefry.split(key, 2)
    dt = dtype_of(cfg.param_dtype)
    z = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    return {"attn": attn_lib.init_gqa(ks[0], cfg, device=device),
            "mlp": init_mlp(ks[1], cfg, device=device),
            "ln_attn": z + 1.0, "ln_mlp": z + 1.0}


def dense_block_apply(p, h, cfg, *, positions=None, cache=None, cur_len=None,
                      window: int = 0, attention=attn_lib.flash_chunked):
    a, new_cache = attn_lib.gqa_apply(p["attn"], _norm(p["ln_attn"], h, cfg),
                                      cfg, window=window, positions=positions,
                                      cache=cache, cur_len=cur_len,
                                      attention=attention)
    h = h + a
    h = h + mlp_apply(p["mlp"], _norm(p["ln_mlp"], h, cfg), cfg)
    return h, new_cache, dict(ZERO_AUX)


# --------------------------------------------------------------------------
# Gemma2 pair (local sliding-window layer + global layer, sandwich norms)


def init_gemma_pair(key, cfg, *, device=None):
    ks = threefry.split(key, 2)
    dt = dtype_of(cfg.param_dtype)
    z = torch.zeros((cfg.d_model,), dtype=dt, device=device)

    def sub(k):
        k1, k2 = threefry.split(k, 2)
        return {"attn": attn_lib.init_gqa(k1, cfg, device=device),
                "mlp": init_mlp(k2, cfg, device=device),
                "ln_attn_pre": z + 0.0, "ln_attn_post": z + 0.0,
                "ln_mlp_pre": z + 0.0, "ln_mlp_post": z + 0.0}

    return {"local": sub(ks[0]), "global": sub(ks[1])}


def _gemma_sub_apply(p, h, cfg, *, window, positions, cache, cur_len,
                     attention):
    a, new_cache = attn_lib.gqa_apply(
        p["attn"], _norm(p["ln_attn_pre"], h, cfg), cfg, window=window,
        positions=positions, cache=cache, cur_len=cur_len,
        attention=attention)
    h = h + _norm(p["ln_attn_post"], a, cfg)
    m = mlp_apply(p["mlp"], _norm(p["ln_mlp_pre"], h, cfg), cfg)
    h = h + _norm(p["ln_mlp_post"], m, cfg)
    return h, new_cache


def gemma_pair_apply(p, h, cfg, *, positions=None, cache=None, cur_len=None,
                     window: int = 0, attention=attn_lib.flash_chunked):
    """The local layer at ``cfg.local_window``, then the global layer at
    window 0 (``window`` is ignored, as in the JAX package)."""
    del window
    h, _ = _gemma_sub_apply(
        p["local"], h, cfg, window=cfg.local_window, positions=positions,
        cache=None if cache is None else cache["local"], cur_len=cur_len,
        attention=attention)
    h, _ = _gemma_sub_apply(
        p["global"], h, cfg, window=0, positions=positions,
        cache=None if cache is None else cache["global"], cur_len=cur_len,
        attention=attention)
    return h, cache, dict(ZERO_AUX)


# --------------------------------------------------------------------------
# MoE block (OLMoE: GQA + routed experts; DeepSeek-V2: MLA + shared and
# routed experts)


def init_moe_block(key, cfg, *, dense_ffn: bool = False, device=None):
    ks = threefry.split(key, 2)
    dt = dtype_of(cfg.param_dtype)
    z = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    attn = (attn_lib.init_mla(ks[0], cfg, device=device) if cfg.is_mla
            else attn_lib.init_gqa(ks[0], cfg, device=device))
    ffn = (init_mlp(ks[1], cfg, device=device) if dense_ffn
           else moe_lib.init_moe(ks[1], cfg, device=device))
    return {"attn": attn, "ffn": ffn, "ln_attn": z + 1.0, "ln_mlp": z + 1.0}


def moe_block_apply(p, h, cfg, *, positions=None, cache=None, cur_len=None,
                    window: int = 0, dense_ffn: bool = False,
                    attention=attn_lib.flash_chunked):
    B, S, D = h.shape
    apply_attn = attn_lib.mla_apply if cfg.is_mla else attn_lib.gqa_apply
    a, new_cache = apply_attn(
        p["attn"], _norm(p["ln_attn"], h, cfg), cfg, window=window,
        positions=positions, cache=cache, cur_len=cur_len,
        attention=attention)
    h = h + a
    x = _norm(p["ln_mlp"], h, cfg)
    if dense_ffn:
        out, aux = mlp_apply(p["ffn"], x, cfg), dict(ZERO_AUX)
    else:
        out, aux = moe_lib.moe_apply(p["ffn"], x.reshape(B * S, D), cfg)
        out = out.reshape(B, S, D)
    return h + out, new_cache, aux


# --------------------------------------------------------------------------
# Mamba2 block


def init_mamba_block(key, cfg, *, device=None):
    dt = dtype_of(cfg.param_dtype)
    z = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    return {"mixer": mamba_lib.init_mamba2(key, cfg, device=device),
            "ln": z + 1.0}


def mamba_block_apply(p, h, cfg, *, positions=None, cache=None, cur_len=None,
                      window: int = 0, attention=None):
    """The Mamba2 mixer on the normed stream (positions, cur_len, window
    and attention unused: the mixer has no attention and no positions)."""
    del positions, cur_len, window, attention
    m, new_cache = mamba_lib.mamba2_apply(p["mixer"], _norm(p["ln"], h, cfg),
                                          cfg, cache=cache)
    return h + m, new_cache, dict(ZERO_AUX)


# --------------------------------------------------------------------------
# Zamba2 super-block: ``shared_attn_every`` Mamba2 blocks, then one
# application of the SHARED dense attention + MLP block (one set of
# parameters for every super-block, a KV cache of its own in each)


def init_zamba_super(key, cfg, *, device=None):
    ks = threefry.split(key, cfg.shared_attn_every)
    return {"mamba": [init_mamba_block(ks[i], cfg, device=device)
                      for i in range(cfg.shared_attn_every)]}


def zamba_super_apply(p, shared_p, h, cfg, *, positions=None, cache=None,
                      cur_len=None, attention=attn_lib.flash_chunked):
    """cache: ``{"mamba": [one per Mamba2 block], "attn": {"k", "v"}}``."""
    for i, bp in enumerate(p["mamba"]):
        h, _, _ = mamba_block_apply(
            bp, h, cfg, cache=None if cache is None else cache["mamba"][i])
    h, _, _ = dense_block_apply(
        shared_p, h, cfg, positions=positions,
        cache=None if cache is None else cache["attn"], cur_len=cur_len,
        attention=attention)
    return h, cache, dict(ZERO_AUX)
