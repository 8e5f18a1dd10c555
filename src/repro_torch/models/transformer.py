"""LMModel for the dense/vlm/audio families (port of
``repro.models.transformer``): embedding, the layer stack and the final
norm -- what ``hidden_states`` runs.

The JAX model stacks its layers (a leading L dim) and applies them with
``lax.scan``; the port keeps one parameter dict per layer and runs them in
a Python loop.  ``init_params`` draws what JAX's ``init_params(key)``
draws: ``split(key, 8)``, then one key per layer from ``split(ks[1], L)``
(JAX's ``vmap`` over those keys draws the same numbers per key), each
tensor drawn on its own so no stacked temporaries exist.

Not ported yet (ROADMAP A8): the gemma2, moe, ssm and hybrid families,
the loss (``loss_and_aux``), decode (``init_cache``, ``serve_step``),
rematerialisation and the sharding plumbing.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import threefry
from repro_torch.core.funcsne import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import flash_chunked
from repro_torch.models.common import dtype_of, embed_init, rms_norm

PORTED_FAMILIES = ("dense", "vlm", "audio")


class LMModel:
    def __init__(self, cfg: ArchConfig, *, attention=flash_chunked):
        """``attention``: ``flash_chunked`` (B8 on the card, the plain
        version on the CPU) or ``models.attention.flash_chunked_ref`` (the
        plain version on either device)."""
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family!r} family ({cfg.name}) is not ported yet; "
                f"the port runs {PORTED_FAMILIES}")
        self.cfg = cfg
        self.attention = attention
        self.n_stack = cfg.n_layers

    # ------------------------------------------------------------------
    # Parameters

    def init_params(self, key, *, device="cuda") -> Dict[str, Any]:
        """Parameters from a threefry key or an int seed (``PRNGKey``)."""
        dev = resolve_device(device)
        if isinstance(key, int):
            key = threefry.prng_key(key)
        cfg = self.cfg
        dt = dtype_of(cfg.param_dtype)
        ks = threefry.split(key, 8)
        p: Dict[str, Any] = {}
        if cfg.input_mode == "tokens":
            p["embed"] = embed_init(ks[0], (cfg.vocab_size, cfg.d_model), dt,
                                    device=dev)
        layer_keys = threefry.split(ks[1], self.n_stack)
        p["blocks"] = [B.init_dense_block(layer_keys[i], cfg, device=dev)
                       for i in range(self.n_stack)]
        p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev) \
            + (0.0 if cfg.norm_plus_one else 1.0)
        if not cfg.tie_embeddings or cfg.input_mode == "embeds":
            p["lm_head"] = embed_init(ks[4], (cfg.d_model, cfg.vocab_size),
                                      dt, device=dev) * cfg.d_model ** -0.5
        return p

    # ------------------------------------------------------------------
    # Forward

    def _embed_in(self, p, inputs):
        cfg = self.cfg
        cd = dtype_of(cfg.compute_dtype)
        if cfg.input_mode == "tokens":
            h = p["embed"][inputs].to(cd)
        else:
            h = inputs.to(cd)
        if cfg.scale_embeddings:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cd, device=h.device)
        return h

    def _run_stack(self, p, h, *, positions=None):
        for bp in p["blocks"]:
            h, _, _ = B.dense_block_apply(bp, h, self.cfg, positions=positions,
                                          attention=self.attention)
        return h

    def hidden_states(self, p, inputs):
        """Final (pre-head) hidden states -- used by embed_latents."""
        h = self._embed_in(p, inputs)
        S = h.shape[1]
        positions = torch.arange(S, device=h.device)[None, :]
        h = self._run_stack(p, h, positions=positions)
        return rms_norm(h, p["final_norm"], plus_one=self.cfg.norm_plus_one)
