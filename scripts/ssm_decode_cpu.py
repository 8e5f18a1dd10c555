#!/usr/bin/env python3
"""Decode against prefill for the SSM families on the CPU, in bf16 and in
float32 compute, sound and with the fault that ``chip_smoke.py`` plants in
phase (p2) / (p3) (the SSM state not decayed): what the card's bound for
them, ``TOL_DECODE_SSM``, rests on.

  python3 scripts/ssm_decode_cpu.py [--arch mamba2-130m] [--layers 24]
                                    [--positions 64] [--width 0]

The model is the registered one (``--width`` > 0 cuts d_model, and with it
d_inner and the heads), random threefry weights, B 2 seeded tokens.
Prefill runs ``hidden_states``; decode ``serve_step`` from a zero cache.
Printed, each as (max |difference| over the largest |prefill logit|,
relative Frobenius error, top-1 agreement): bf16 compute with a bf16
cache, the same with the state not decayed, and float32 compute with a
float32 cache.  About 1 min at the defaults.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.models import mamba2 as mamba_lib  # noqa: E402
from repro_torch.models.transformer import LMModel  # noqa: E402


@torch.inference_mode()
def reading(model, params, x, cache_dtype):
    """Decode of every position against the prefill's logits."""
    full = model._logits_fn(params)(model.hidden_states(params, x)).float()
    cache = model.init_cache(x.shape[0], x.shape[1], dtype=cache_dtype,
                             device="cpu")
    dec = []
    for t in range(x.shape[1]):
        lg, cache = model.serve_step(params, cache, x[:, t:t + 1],
                                     torch.tensor(t + 1, dtype=torch.int32))
        dec.append(lg[:, 0].float())
    dec = torch.stack(dec, 1)
    diff = dec - full
    return (float(diff.abs().max() / full.abs().max()),
            float(diff.norm() / full.norm()),
            float((dec.argmax(-1) == full.argmax(-1)).float().mean()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--positions", type=int, default=64)
    ap.add_argument("--width", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    kw = {"n_layers": args.layers}
    if args.width:
        kw["d_model"] = args.width
    cfg = dataclasses.replace(get_arch(args.arch), **kw)
    model = LMModel(cfg)
    params = model.init_params(0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, args.positions)))
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_nheads} heads of {cfg.ssm_headdim}, state "
          f"{cfg.ssm_state}; B 2 x {args.positions} positions")
    fmt = "max rel {:.3e}, Frobenius {:.3e}, top-1 {:.4f}"
    print("bf16, sound:            " + fmt.format(
        *reading(model, params, x, torch.bfloat16)))
    sound = mamba_lib._state_decay
    mamba_lib._state_decay = lambda dt, A: torch.ones_like(dt * A[None, :])
    try:
        print("bf16, state not decayed: " + fmt.format(
            *reading(model, params, x, torch.bfloat16)))
    finally:
        mamba_lib._state_decay = sound
    m32 = LMModel(dataclasses.replace(cfg, compute_dtype="float32"))
    print("float32, sound:         " + fmt.format(
        *reading(m32, params, x, torch.float32)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
