"""Optimisers as (init, update) pairs over parameter trees (port of
``repro.optim.optimizers``).

- ``adamw``: decoupled weight decay; ``moment_dtype='int8'`` stores m/v as
  blockwise-quantised QTensors (8-bit Adam) for the >30B assigned archs.
- ``sgdm``: momentum SGD (ablations / NE experiments).
- ``clip_by_global_norm``: standard pre-update gradient clip.

A tree is the port's parameter layout: dicts and lists (the per-layer
blocks) of tensors; the state's ``m``, ``v`` and ``mom`` mirror it, with
QTensor leaves for int8 moments.  The arithmetic is the JAX package's,
operation for operation, in float32.

``update(grads, state, params) -> (params, state)`` keeps the JAX
signature but updates in place under ``no_grad``, on either device: the
parameters, the moments (a QTensor's payload and scales) and, in
``clip_by_global_norm``, the gradients.  That is PyTorch's counterpart of
the JAX trainer's ``donate_argnums=(0, 1)``: a full-width model never holds
two copies of its parameters or moments.  The returned trees are the ones
passed in; only ``count`` is a new tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.optim.quantized import QTensor, dequantize, quantize

ScheduleOrFloat = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples of
    tensors) and the matching leaves of the trees in ``rest``; a QTensor
    is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, QTensor):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order (dict insertion, list index)."""
    out = []
    tree_map(out.append, tree)
    return out


def _lr_at(lr: ScheduleOrFloat, count):
    return lr(count) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=count.device)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / global norm), in place;
    returns ``(grads, global_norm)``."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in leaves:
        g.copy_((g.float() * scale).to(g.dtype))
    return grads, gn


class AdamWState(NamedTuple):
    count: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def adamw(lr: ScheduleOrFloat, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          moment_dtype: str = "float32") -> Optimizer:
    quant = moment_dtype == "int8"

    def enc(x):
        return quantize(x) if quant else x

    def dec(x):
        return dequantize(x) if quant else x.float()

    def init(params):
        def zeros(p):
            return enc(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device))
        dev = tree_leaves(params)[0].device
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        count = state.count + 1
        lr_t = _lr_at(lr, count)
        c1 = 1.0 - b1 ** count.float()
        c2 = 1.0 - b2 ** count.float()

        def upd(g, m_old, v_old, p):
            g32 = g.float()
            m = b1 * dec(m_old) + (1.0 - b1) * g32
            v = b2 * dec(v_old) + (1.0 - b2) * g32 * g32
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            step = step + weight_decay * p.float()
            p.copy_((p.float() - lr_t * step).to(p.dtype))
            for old, new in ((m_old, enc(m)), (v_old, enc(v))):
                if quant:
                    old.q.copy_(new.q)
                    old.scale.copy_(new.scale)
                else:
                    old.copy_(new)

        tree_map(upd, grads, state.m, state.v, params)
        return params, AdamWState(count=count, m=state.m, v=state.v)

    return Optimizer(init=init, update=update)


class SGDMState(NamedTuple):
    count: torch.Tensor
    mom: Any


def sgdm(lr: ScheduleOrFloat, *, momentum: float = 0.9,
         nesterov: bool = False) -> Optimizer:
    def init(params):
        dev = tree_leaves(params)[0].device
        return SGDMState(count=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                         mom=tree_map(lambda p: torch.zeros(
                             p.shape, dtype=torch.float32, device=p.device),
                             params))

    @torch.no_grad()
    def update(grads, state: SGDMState, params):
        count = state.count + 1
        lr_t = _lr_at(lr, count)

        def upd(g, m_old, p):
            g32 = g.float()
            m = momentum * m_old + g32
            step = g32 + momentum * m if nesterov else m
            p.copy_((p.float() - lr_t * step).to(p.dtype))
            m_old.copy_(m)

        tree_map(upd, grads, state.mom, params)
        return params, SGDMState(count=count, mom=state.mom)

    return Optimizer(init=init, update=update)
