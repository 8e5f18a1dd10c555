#!/usr/bin/env python3
"""Decode against prefill for Gemma2's topology in bf16 on the CPU, sound
and with the two faults that ``chip_smoke.py`` plants in phase (o1): a
small-width stand-in that says how far each fault reading should sit
above the sound one before the card measures it at full size.

  python3 scripts/decode_faults_cpu.py [--window 128] [--width 512]
                                       [--layers 26] [--vocab 32000]

The model is ``gemma2-2b`` with the width, the vocabulary and the local
window cut (heads 8 / 4 of width / 8, d_ff 4 x width), random threefry
weights, B 2 seeded tokens over the window plus a sixteenth of it, as the
card's run decodes 4,096 + 256.  Prefill runs through the plain
``flash_chunked_ref``; decode through ``serve_step``.  Printed, each as
(max |difference| over the largest |prefill logit|, relative Frobenius
error, top-1 agreement): the sound decode at the first 64 positions and
past the window; the cache read one slot off over the first 64 positions;
the local layers' window mask off past the window, resumed from the sound
run's cache where the window starts to bite.
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
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models.transformer import LMModel  # noqa: E402

FIRST = 64


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--layers", type=int, default=26)
    ap.add_argument("--vocab", type=int, default=32000)
    a = ap.parse_args(argv)
    W, d, V = a.window, a.width, a.vocab
    S = W + max(1, W // 16)
    cfg = dataclasses.replace(
        get_arch("gemma2-2b"), d_model=d, n_heads=8, n_kv_heads=4,
        head_dim=d // 8, d_ff=4 * d, vocab_size=V, local_window=W,
        n_layers=a.layers)
    model = LMModel(cfg, attention=attn_lib.flash_chunked_ref)
    params = model.init_params(0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, V, (2, S)))
    full = model._logits_fn(params)(model.hidden_states(params, tok)).float()
    full = cfg.final_softcap * torch.tanh(full / cfg.final_softcap)
    scale = float(full.abs().max())

    def decode(m, cache, lo, hi):
        out = []
        for t in range(lo, hi):
            lg, cache = m.serve_step(params, cache, tok[:, t:t + 1],
                                     torch.tensor(t + 1, dtype=torch.int32))
            out.append(lg[:, 0].float())
        return torch.stack(out, 1)

    def reading(dec, ref):
        diff = dec - ref
        return (float(diff.abs().max()) / scale,
                float(diff.norm() / ref.norm()),
                float((dec.argmax(-1) == ref.argmax(-1)).float().mean()))

    cache = model.init_cache(2, S, device="cpu")
    first = decode(model, cache, 0, W)[:, :FIRST]
    snap = _clone(cache)
    last = decode(model, cache, W, S)
    print(f"gemma2 topology: width {d}, {a.layers} layers, vocab {V}, "
          f"window {W}, {S} positions, bf16 compute")
    print("sound, first 64:", reading(first, full[:, :FIRST]))
    print("sound, past the window:", reading(last, full[:, W:]))

    sound = attn_lib.decode_attention

    def shifted(q, k_cache, v_cache, cur_len, **kw):
        return sound(q, k_cache.roll(1, dims=1), v_cache.roll(1, dims=1),
                     cur_len, **kw)
    attn_lib.decode_attention = shifted
    try:
        slot = decode(model, model.init_cache(2, S, device="cpu"), 0, FIRST)
    finally:
        attn_lib.decode_attention = sound
    print("cache slot + 1, first 64:", reading(slot, full[:, :FIRST]))
    unwindowed = LMModel(dataclasses.replace(cfg, local_window=0))
    print("window mask off, past the window:",
          reading(decode(unwindowed, snap, W, S), full[:, W:]))


if __name__ == "__main__":
    main()
