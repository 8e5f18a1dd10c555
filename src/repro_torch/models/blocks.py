"""The dense transformer block (port of the dense family of
``repro.models.blocks``: ``init_mlp``, ``mlp_apply``, ``_norm``,
``init_dense_block``, ``dense_block_apply``).

A block apply returns ``(h_new, new_cache, aux)`` as in the JAX package;
``aux`` carries MoE router losses, zeros here.  The gemma2 pair, MoE,
Mamba2 and Zamba2 blocks are not ported yet (ROADMAP A8).
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (dense_init, dtype_of, gelu, rms_norm,
                                       swiglu)

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
    g = x @ p["w_gate"].to(cd)
    u = x @ p["w_up"].to(cd)
    h = gelu(g) * u if cfg.mlp_act == "geglu" else swiglu(g, u)
    return h @ p["w_down"].to(cd)


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
