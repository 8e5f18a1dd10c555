"""Train and serve step builders (port of ``repro.launch.steps``:
``make_model``, ``make_optimizer``, ``make_train_step`` and
``make_serve_step``).

The port runs one device, so ``make_model`` takes no sharding context.
The train step differentiates with ``torch.autograd.grad`` (B8's backward
kernel on the card), clips in place and updates in place (``optim``): the
counterpart of the JAX trainer's ``jit(..., donate_argnums=(0, 1))``.

Not ported: ``batch_struct``, ``decode_structs`` and
``params_and_opt_structs``, the ``ShapeDtypeStruct`` stand-ins that only
the XLA dry-run reads (ROADMAP Queue A, item 3).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import LMModel
from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine
from repro_torch.optim.optimizers import tree_leaves, tree_map


def make_model(cfg: ArchConfig) -> LMModel:
    """The model of ``cfg`` on one device."""
    return LMModel(cfg)


def make_optimizer(cfg: ArchConfig, *, peak_lr: float = 3e-4,
                   warmup: int = 200, total: int = 10000):
    return adamw(warmup_cosine(peak_lr, warmup, total),
                 moment_dtype=cfg.opt_state_dtype)


def make_train_step(model: LMModel, opt, *, clip_norm: float = 1.0):
    """(params, opt_state, batch{inputs,labels}) -> (params, opt_state,
    metrics): the loss, ``torch.autograd.grad`` over the parameter leaves
    (a leaf that the loss does not reach gets zeros, as JAX's), the clip,
    then ``opt.update``.  The metrics are ``loss_and_aux``'s plus ``loss``
    and ``grad_norm``, detached 0-d tensors."""

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, metrics = model.loss_and_aux(params, batch["inputs"],
                                           batch["labels"])
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        grads, gnorm = clip_by_global_norm(
            tree_map(lambda _: next(grads), params), clip_norm)
        params, opt_state = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def make_serve_step(model: LMModel):
    """``serve_step(params, cache, inputs, cur_len) -> (logits, cache)``."""
    def serve_step(params, cache, inputs, cur_len):
        return model.serve_step(params, cache, inputs, cur_len)

    return serve_step
