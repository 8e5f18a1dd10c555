"""Blockwise int8 quantisation for optimiser moments, 8-bit Adam style
(port of ``repro.optim.quantized``).

The layout is the JAX package's: the int8 payload keeps the parameter's
own shape and blocks run along the last axis, each block (the largest
divisor of the last dim that is <= 256) with one float32 scale, its absmax
over 127; values are rounded half to even (``torch.round``, as
``jnp.round``) and clipped to [-127, 127].

``QTensor`` is a NamedTuple ``(q, scale)``, so the port's checkpointer
saves and restores it as it is (``.q``, ``.scale``); ``shape`` and
``block`` derive from the two.  A 0-d source: the JAX package reshapes it
to (1,) and its payload stays (1,) beside the recorded shape (); the
port's payload keeps the shape () (one element either way), so that the
shape derives from it, and the scale is (1,) in both.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK = 256


def _block_for(last_dim: int) -> int:
    b = min(BLOCK, max(last_dim, 1))
    while last_dim % b:
        b -= 1
    return max(b, 1)


class QTensor(NamedTuple):
    q: torch.Tensor        # int8, the source's shape
    scale: torch.Tensor    # float32 (*shape[:-1], last / block); (1,) at 0-d

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def block(self) -> int:
        return self.q.shape[-1] // self.scale.shape[-1] if self.q.dim() else 1


def quantize(x) -> QTensor:
    x = torch.as_tensor(x)
    shape = x.shape
    if x.dim() == 0:
        x = x.reshape(1)
    b = _block_for(x.shape[-1])
    blocks = x.float().reshape(*x.shape[:-1], -1, b)
    absmax = blocks.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return QTensor(q=q.to(torch.int8).reshape(shape), scale=scale)


def dequantize(t: QTensor) -> torch.Tensor:
    q = t.q.float().reshape(-1) if t.q.dim() == 0 else t.q.float()
    blocks = q.reshape(*q.shape[:-1], -1, t.block)
    return (blocks * t.scale[..., None]).reshape(t.shape)
