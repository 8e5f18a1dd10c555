"""The state and weight bridges between the port and the JAX package.

Both sides meet in numpy: the JAX ``FuncSNEState``'s fields as numpy
arrays, with its PRNG key given as ``jax.random.key_data(key)`` words (a
uint32 array of shape (2,)).  The port carries those words, so its counter
hash folds the same salt and draws the same candidates and negatives.
The reverse-edge cache (``rev_idx`` (N, c_hd_rev), ``rev_step``) crosses
both ways, so a bridged state keeps the JAX package's rebuild cadence.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.funcsne import (FuncSNEConfig, FuncSNEState,
                                      resolve_device)

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


def lm_params_from_jax(params_np, device="cuda") -> dict:
    """The port's LM parameters from JAX ``LMModel.init_params`` output
    given as numpy (e.g. ``jax.tree.map(np.asarray, params)``).

    JAX stacks the layers: each leaf of ``params["blocks"]`` has a leading
    L dim.  The port keeps a list of per-layer dicts of the same keys;
    every other entry (``embed``, ``final_norm``, ``lm_head``) is copied.
    """
    dev = resolve_device(device)

    def tree(x, index=None):
        if isinstance(x, Mapping):
            return {k: tree(v, index) for k, v in x.items()}
        a = np.asarray(x)
        a = np.array(a if index is None else a[index])
        if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(a).to(dev)
    out = {k: tree(v) for k, v in params_np.items() if k != "blocks"}
    blocks = params_np["blocks"]
    n_layers = len(np.asarray(blocks["ln_attn"]))
    out["blocks"] = [tree(blocks, i) for i in range(n_layers)]
    return out
