"""LMModel (port of ``repro.models.transformer``): embedding, the layer
stack, the final norm and the head -- ``hidden_states`` and the serving
path (``init_cache``, ``serve_step``) -- for every family:

  dense / vlm / audio : dense GQA blocks
  gemma2              : (local, global) pairs, sandwich norms
  moe                 : MoE blocks with GQA (OLMoE) or MLA (DeepSeek-V2)
                        attention, with an optional dense first layer
  ssm                 : Mamba2 blocks
  hybrid              : Zamba2 super-blocks (``shared_attn_every`` Mamba2
                        blocks, then the one shared dense block)

The JAX model stacks its layers (a leading L dim) and applies them with
``lax.scan``; the port keeps one parameter dict per layer, and one cache
dict per layer, and runs them in a Python loop (a Zamba2 super-block's
Mamba2 blocks, stacked again in JAX, are a list).  ``init_params`` draws
what JAX's ``init_params(key)`` draws: ``split(key, 8)``, then one key per
layer from ``split(ks[1], L)`` (JAX's ``vmap`` over those keys draws the
same numbers per key), each tensor drawn on its own so no stacked
temporaries exist.

``serve_step`` writes the new token into the cache in place and returns
that cache (the JAX step returns a new one); its ``cur_len`` is a 0-d
integer tensor on the model's device, and nothing in the step reads a
device value on the host.

``loss_and_aux`` (``apply_train``) is the train loss: the mean NLL of
``cross_entropy_chunked`` plus, for MoE, the router losses weighted by
``router_aux_weight`` and ``router_z_weight``.  It differentiates on either
device: on the card B8's forward and backward kernels carry attention
(``models.attention.FlashAttention``).  Rematerialisation: with
``cfg.remat``, a forward that records a backward and no cache, each
stacked block's apply (not MoE's dense first layer, as in JAX) runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, the counterpart
of the JAX scan body's ``jax.checkpoint``: ``remat_policy="nothing"`` keeps
only the block's input, ``"dots_no_batch"`` also the outputs of its 2-D
matrix products (``aten.mm`` / ``aten.addmm``: the projections; not the
batched expert and per-head products), ``"none"`` turns it off.  The
recomputation runs B8's forward a second time a layer.  A forward that
records no backward (grad mode off, or nothing requiring grad) runs
without the checkpoint, so serving and ``hidden_states`` launch what they
launched before.

Not ported: the sharding plumbing (``param_specs``, ``cache_specs``): the
port runs one device.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.core import threefry
from repro_torch.core.funcsne import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import flash_chunked
from repro_torch.models.common import (cross_entropy_chunked, dtype_of,
                                       embed_init, matmul_cd, rms_norm)
from repro_torch.optim.optimizers import tree_leaves

# the products "dots_no_batch" keeps: 2-D matrix products, nothing batched
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_no_batch(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _builds_graph(p, h) -> bool:
    """Whether the stack's forward records a backward: grad mode on and
    the stream or a weight requiring grad.  Remat only matters then; a
    forward that records none (serving, ``hidden_states`` on weights that
    need no grad) runs the blocks as they are."""
    return torch.is_grad_enabled() and (
        h.requires_grad or any(t.requires_grad for t in tree_leaves(p)))


def _remat(apply_block, policy):
    """``apply_block`` under a non-reentrant checkpoint with ``policy``
    ("nothing" or "dots_no_batch")."""
    kw = {}
    if policy == "dots_no_batch":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_no_batch)
    elif policy != "nothing":
        raise ValueError(f"unknown remat_policy {policy!r}")

    def run(bp, hh, cfg, **block_kw):
        return checkpoint(apply_block, bp, hh, cfg, use_reentrant=False,
                          **kw, **block_kw)
    return run


class LMModel:
    def __init__(self, cfg: ArchConfig, *, attention=flash_chunked):
        """``attention``: ``flash_chunked`` (B8 on the card, the plain
        version on the CPU) or ``models.attention.flash_chunked_ref`` (the
        plain version on either device)."""
        fam = cfg.family
        self.cfg = cfg
        self.attention = attention
        if fam == "gemma2":
            assert cfg.n_layers % 2 == 0
            self.n_stack = cfg.n_layers // 2
            self._init_block = B.init_gemma_pair
            self._apply_block = B.gemma_pair_apply
        elif fam == "moe":
            self.n_stack = cfg.n_layers - (1 if cfg.moe_dense_first else 0)
            self._init_block = B.init_moe_block
            self._apply_block = B.moe_block_apply
        elif fam == "ssm":
            self.n_stack = cfg.n_layers
            self._init_block = B.init_mamba_block
            self._apply_block = B.mamba_block_apply
        elif fam == "hybrid":
            assert cfg.n_layers % cfg.shared_attn_every == 0
            self.n_stack = cfg.n_layers // cfg.shared_attn_every
            self._init_block = B.init_zamba_super
            self._apply_block = None      # _run_stack: the shared params
        else:                             # dense / vlm / audio
            self.n_stack = cfg.n_layers
            self._init_block = B.init_dense_block
            self._apply_block = B.dense_block_apply
        cd = dtype_of(cfg.compute_dtype)
        # sqrt(d_model) rounded to the compute dtype, as the JAX model's
        # jnp.asarray(d ** 0.5, cd): a product of it and a value of that
        # dtype rounds once either way
        self._embed_scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=cd))

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
        p["blocks"] = [self._init_block(layer_keys[i], cfg, device=dev)
                       for i in range(self.n_stack)]
        if cfg.family == "hybrid":
            p["shared"] = B.init_dense_block(ks[2], cfg, device=dev)
        if cfg.family == "moe" and cfg.moe_dense_first:
            p["first"] = B.init_moe_block(ks[3], cfg, dense_ffn=True,
                                          device=dev)
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
            h = h * self._embed_scale
        return h

    def _logits_fn(self, p):
        """h -> h @ head in the compute dtype; the head is the tied
        embedding's transpose where the config ties it."""
        cfg = self.cfg
        cd = dtype_of(cfg.compute_dtype)
        head = (p["embed"].T if (cfg.tie_embeddings
                                 and cfg.input_mode == "tokens"
                                 and "lm_head" not in p)
                else p["lm_head"])
        return lambda h: matmul_cd(h.to(cd), head.to(cd))

    def _run_stack(self, p, h, *, positions=None, cache=None, cur_len=None):
        """The layers (and a dense first layer), with or without a cache.
        Returns ``(h, cache, aux)``: the cache written in place (None
        without one); ``aux`` each router loss's mean over the stacked
        layers, 0-d float32 tensors."""
        cfg = self.cfg
        decode = cache is not None
        apply_block = self._apply_block
        if cfg.family == "hybrid":
            def apply_block(bp, hh, cfg_, **kw):
                return B.zamba_super_apply(bp, p["shared"], hh, cfg_, **kw)
        if (cfg.remat and not decode and cfg.remat_policy != "none"
                and _builds_graph(p, h)):
            apply_block = _remat(apply_block, cfg.remat_policy)
        if cfg.family == "moe" and cfg.moe_dense_first:
            h, _, _ = B.moe_block_apply(
                p["first"], h, cfg, positions=positions,
                cache=cache["first"] if decode else None, cur_len=cur_len,
                dense_ffn=True, attention=self.attention)
        auxs = []
        for i, bp in enumerate(p["blocks"]):
            h, _, aux = apply_block(
                bp, h, cfg, positions=positions,
                cache=cache["blocks"][i] if decode else None,
                cur_len=cur_len, attention=self.attention)
            auxs.append(aux)
        out_aux = {}
        for name in B.ZERO_AUX:
            vals = [a[name] for a in auxs]
            if all(torch.is_tensor(v) for v in vals):
                out_aux[name] = torch.stack(vals).mean()
            else:                         # blocks without a router
                out_aux[name] = torch.zeros((), dtype=torch.float32,
                                            device=h.device)
        return h, cache, out_aux

    def hidden_states(self, p, inputs):
        """Final (pre-head) hidden states -- used by embed_latents."""
        h = self._embed_in(p, inputs)
        S = h.shape[1]
        positions = torch.arange(S, device=h.device)[None, :]
        h, _, _ = self._run_stack(p, h, positions=positions)
        return rms_norm(h, p["final_norm"], plus_one=self.cfg.norm_plus_one)

    def apply_train(self, p, inputs, labels, valid=None):
        """Causal-LM loss (alias of loss_and_aux)."""
        return self.loss_and_aux(p, inputs, labels, valid=valid)

    def loss_and_aux(self, p, inputs, labels, valid=None):
        """Train loss including MoE aux terms (the train step's entry
        point): ``(total, metrics)``, the metrics ``nll``, ``tokens`` and
        the router losses, 0-d float32 tensors."""
        cfg = self.cfg
        h = self._embed_in(p, inputs)
        S = h.shape[1]
        positions = torch.arange(S, device=h.device)[None, :]
        h, _, aux = self._run_stack(p, h, positions=positions)
        h = rms_norm(h, p["final_norm"], plus_one=cfg.norm_plus_one)
        nll, n_tok = cross_entropy_chunked(
            self._logits_fn(p), h, labels, n_chunks=cfg.logits_chunks,
            final_softcap=cfg.final_softcap, valid=valid)
        total = nll
        if cfg.is_moe:
            total = total + cfg.router_aux_weight * aux["load_balance"] \
                + cfg.router_z_weight * aux["router_z"]
        metrics = {"nll": nll, "tokens": n_tok, **aux}
        return total, metrics

    # ------------------------------------------------------------------
    # Serving

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device="cuda"):
        """Zero caches: ``{"blocks": [per-layer cache], "first": ...}``.
        A GQA layer's is ``{"k", "v"}`` of shape (batch, max_len, Hkv, Dh)
        (a Gemma2 pair's ``{"local": ..., "global": ...}``); an MLA
        layer's ``{"latent" (batch, max_len, kv_lora_rank), "k_rope"
        (batch, max_len, q_rope_dim)}``; a Mamba2 layer's ``{"conv"
        (batch, ssm_conv - 1, H, P) in ``dtype``, "ssm" (batch, H, N, P)
        in float32}``; a Zamba2 super-block's ``{"mamba": [one per Mamba2
        block], "attn": {"k", "v"}}``."""
        dev = resolve_device(device)
        cfg = self.cfg

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        def kv():
            shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            return {"k": zeros(*shape), "v": zeros(*shape)}

        def latent():
            return {"latent": zeros(batch, max_len, cfg.kv_lora_rank),
                    "k_rope": zeros(batch, max_len, cfg.q_rope_dim)}

        def mamba():
            H, Pd = cfg.ssm_nheads, cfg.ssm_headdim
            return {"conv": zeros(batch, cfg.ssm_conv - 1, H, Pd),
                    "ssm": zeros(batch, H, cfg.ssm_state, Pd,
                                 dt=torch.float32)}

        if cfg.family == "gemma2":
            def layer():
                return {"local": kv(), "global": kv()}
        elif cfg.family == "ssm":
            layer = mamba
        elif cfg.family == "hybrid":
            def layer():
                return {"mamba": [mamba() for _ in
                                  range(cfg.shared_attn_every)],
                        "attn": kv()}
        else:
            layer = latent if cfg.is_mla else kv
        cache = {"blocks": [layer() for _ in range(self.n_stack)]}
        if cfg.family == "moe" and cfg.moe_dense_first:
            cache["first"] = latent() if cfg.is_mla else kv()
        return cache

    @torch.inference_mode()
    def serve_step(self, p, cache, inputs, cur_len):
        """One decode step.  inputs: (B, 1) tokens or (B, 1, D) embeds;
        cur_len: 0-d integer tensor, the length including the new token.
        Returns ``(logits (B, 1, V), cache)``: logits in the compute dtype,
        or in float32 after the final softcap; the cache written in place.
        Forward only, as the JAX step: it runs in inference mode, which
        spares each of a step's thousands of small ops the autograd
        bookkeeping."""
        h = self._embed_in(p, inputs)
        h, cache, _ = self._run_stack(p, h, cache=cache, cur_len=cur_len)
        h = rms_norm(h, p["final_norm"], plus_one=self.cfg.norm_plus_one)
        logits = self._logits_fn(p)(h)
        cap = self.cfg.final_softcap
        if cap:
            logits = cap * torch.tanh(logits.float() / cap)
        return logits, cache
