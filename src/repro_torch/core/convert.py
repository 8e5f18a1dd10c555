"""The state and weight bridges between the port and the JAX package.

Both sides meet in numpy: the JAX ``FuncSNEState``'s fields as numpy
arrays, with its PRNG key given as ``jax.random.key_data(key)`` words (a
uint32 array of shape (2,)).  The port carries those words, so its counter
hash folds the same salt and draws the same candidates and negatives.
The reverse-edge cache (``rev_idx`` (N, c_hd_rev), ``rev_step``) crosses
both ways, so a bridged state keeps the JAX package's rebuild cadence.

The LM bridges unstack the JAX model's layers into the port's per-layer
lists: parameters (and a JAX gradient tree, which has their structure),
caches, and an AdamW state whose moments mirror the parameters, int8
QTensor moments included (``adamw_state_from_jax``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.funcsne import (FuncSNEConfig, FuncSNEState,
                                      resolve_device)
from repro_torch.optim.optimizers import AdamWState
from repro_torch.optim.quantized import QTensor

_DTYPES = {
    "Y": np.float32, "vel": np.float32, "gains": np.float32,
    "hd_idx": np.int32, "hd_d": np.float32, "ld_idx": np.int32,
    "ld_d": np.float32, "beta": np.float32, "new_flag": np.bool_,
    "active": np.bool_, "ema_new_frac": np.float32, "zhat": np.float32,
    "step": np.int32, "rng": np.uint32, "rev_idx": np.int32,
    "rev_step": np.int32,
}


def _shapes(cfg: FuncSNEConfig):
    n, d = cfg.n_points, cfg.dim_ld
    return {"Y": (n, d), "vel": (n, d), "gains": (n, d),
            "hd_idx": (n, cfg.k_hd), "hd_d": (n, cfg.k_hd),
            "ld_idx": (n, cfg.k_ld), "ld_d": (n, cfg.k_ld), "beta": (n,),
            "new_flag": (n,), "active": (n,), "ema_new_frac": (),
            "zhat": (), "step": (), "rng": (2,),
            "rev_idx": (n, cfg.c_hd_rev), "rev_step": ()}


def state_from_numpy(fields: Mapping, cfg: FuncSNEConfig,
                     device="cuda") -> FuncSNEState:
    """Port state from numpy fields (see the module docstring)."""
    dev = resolve_device(device)
    shapes = _shapes(cfg)
    out = {}
    for name, dtype in _DTYPES.items():
        a = np.asarray(fields[name])
        if a.shape != shapes[name]:
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{shapes[name]}")
        # np.array copies C-contiguous and keeps 0-d shapes; the uint32
        # key words ride in int64
        a = np.array(a, dtype=np.int64 if name == "rng" else dtype)
        out[name] = torch.from_numpy(a).to(dev)
    return FuncSNEState(**out)


def state_to_numpy(st: FuncSNEState) -> dict:
    """numpy fields of a port state (``rng`` as uint32 key words)."""
    out = {}
    for name, dtype in _DTYPES.items():
        out[name] = getattr(st, name).detach().cpu().numpy().astype(dtype)
    return out


def _is_qtensor(x) -> bool:
    """A JAX ``repro.optim.quantized.QTensor`` (or the port's): int8
    payload ``q`` and float32 ``scale``."""
    return hasattr(x, "q") and hasattr(x, "scale")


def _leaf_array(x):
    return np.asarray(x.q if _is_qtensor(x) else x)


def _torch_tree(x, dev, index=None):
    """A nested dict of numpy arrays (or one array) as torch tensors on
    ``dev``, each leaf's row ``index`` if given; ml_dtypes' bfloat16
    becomes torch bfloat16, every other dtype stays as it is.  A QTensor
    leaf becomes the port's ``QTensor`` of its payload and scales (a 0-d
    source's (1,) payload reshaped to its recorded shape ())."""
    if isinstance(x, Mapping):
        return {k: _torch_tree(v, dev, index) for k, v in x.items()}
    if _is_qtensor(x):
        q = _torch_tree(x.q, dev, index)
        if index is None and tuple(x.shape) == ():
            q = q.reshape(())
        return QTensor(q=q, scale=_torch_tree(x.scale, dev, index))
    a = np.asarray(x)
    a = np.array(a if index is None else a[index])
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(a).to(dev)


def _n_stacked(tree) -> int:
    """The leading (layer) dim of the first leaf of a stacked tree."""
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return len(_leaf_array(tree))


def _layer(blocks, dev, i):
    """Layer ``i`` of a stacked ``blocks`` tree.  A Zamba2 super-block's
    ``mamba`` entry is stacked twice, (L, e): it becomes a list of the e
    Mamba2 blocks' trees."""
    layer = _torch_tree(blocks, dev, i)
    if isinstance(blocks, Mapping) and "mamba" in blocks:
        stacked = blocks["mamba"]
        leaf = stacked
        while isinstance(leaf, Mapping):
            leaf = next(iter(leaf.values()))
        layer["mamba"] = [_torch_tree(stacked, dev, (i, j))
                          for j in range(_leaf_array(leaf).shape[1])]
    return layer


def _unstacked(tree, stacked_key: str, dev) -> dict:
    out = {k: _torch_tree(v, dev) for k, v in tree.items()
           if k != stacked_key}
    blocks = tree[stacked_key]
    out[stacked_key] = [_layer(blocks, dev, i)
                        for i in range(_n_stacked(blocks))]
    return out


def lm_params_from_jax(params_np, device="cuda") -> dict:
    """The port's LM parameters from JAX ``LMModel.init_params`` output
    given as numpy (e.g. ``jax.tree.map(np.asarray, params)``).

    JAX stacks the layers: each leaf of ``params["blocks"]`` has a leading
    L dim (a Gemma2 pair's ``local`` / ``global`` dicts and a MoE block's
    ``ffn`` dict included).  The port keeps a list of per-layer dicts of
    the same nested keys; a Zamba2 super-block's ``mamba`` leaves, (L, e)
    in JAX, become a list of e per-block dicts in each layer.  Every other
    entry (``embed``, ``final_norm``, ``lm_head``, a dense ``first``
    layer, Zamba2's ``shared`` block) is copied.  Each leaf keeps its
    dtype (the MoE router and Mamba2's A_log, dt_bias and D_skip stay
    float32).
    """
    return _unstacked(params_np, "blocks", resolve_device(device))


def lm_cache_from_jax(cache_np, device="cuda") -> dict:
    """The port's cache (``LMModel.init_cache``'s layout: a list of
    per-layer dicts under ``blocks``; Zamba2's Mamba2 caches a list in
    each layer) from a JAX ``init_cache`` / ``serve_step`` cache given as
    numpy, whose ``blocks`` leaves are stacked over the layers (Zamba2's
    ``mamba`` leaves over (L, e))."""
    return _unstacked(cache_np, "blocks", resolve_device(device))


def adamw_state_from_jax(state_np, device="cuda") -> AdamWState:
    """The port's ``AdamWState`` from a JAX ``repro.optim.adamw`` state
    given as numpy (``jax.tree.map(np.asarray, state)``): ``count`` as a
    0-d int32 tensor, and ``m`` and ``v``, which mirror the JAX parameter
    tree, unstacked as ``lm_params_from_jax`` unstacks it; int8 moments
    (QTensor leaves) carry their payloads and scales across, a layer's
    slice of each."""
    dev = resolve_device(device)
    return AdamWState(count=_torch_tree(state_np.count, dev),
                      m=_unstacked(state_np.m, "blocks", dev),
                      v=_unstacked(state_np.v, "blocks", dev))
