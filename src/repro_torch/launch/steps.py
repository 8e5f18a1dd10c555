"""Serve step builder (port of ``repro.launch.steps``: ``make_model`` and
``make_serve_step``).

The port runs one device, so ``make_model`` takes no sharding context.  The
train and
optimiser builders (``make_train_step``, ``make_optimizer``) and the
dry-run's shape structs are not ported yet (ROADMAP A8.6).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import LMModel


def make_model(cfg: ArchConfig) -> LMModel:
    """The model of ``cfg`` on one device."""
    return LMModel(cfg)


def make_serve_step(model: LMModel):
    """``serve_step(params, cache, inputs, cur_len) -> (logits, cache)``."""
    def serve_step(params, cache, inputs, cur_len):
        return model.serve_step(params, cache, inputs, cur_len)

    return serve_step
