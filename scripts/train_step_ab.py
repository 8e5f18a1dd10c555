#!/usr/bin/env python3
"""``examples/train_lm``'s step time on one CUDA card, with and without
``chip_smoke.py``'s (q2) gradient check run before it in the same process.

  python3 scripts/train_step_ab.py [--steps 300] [--rounds 1]

Each turn is a process of its own (``chip_smoke``'s phase setup: no TF32)
that runs reduced qwen2-7b's ``train_lm`` for ``--steps`` steps into a
fresh checkpoint directory, after ``train_q2_grads`` in the "check" turns.
A round runs plain, check, check, plain, so a drift of the host or the
card over the call falls on both.  Prints one line a turn (median and
first ms a step, the Python objects alive and the card's allocated bytes
before the run), then the card's name and power limit, then one JSON line
with every turn.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(variant: str, steps: int) -> dict:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    dev = chip_smoke._serve_setup(f"ab {variant}")
    from repro_torch.configs.base import get_arch
    from repro_torch.examples import train_lm
    from repro_torch.launch.train import reduced_variant
    cfg = reduced_variant(get_arch("qwen2-7b"))
    if variant == "check":
        chip_smoke.train_q2_grads(cfg, 8, 256, dev)
    gc.collect()
    objects = len(gc.get_objects())
    allocated = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as d:
        hist = train_lm.main(["--ckpt-dir", d, "--steps", str(steps)])
    ms = sorted(1e3 * h["sec"] for h in hist[1:])
    return {"variant": variant, "median_ms": ms[len(ms) // 2],
            "first_ms": 1e3 * hist[0]["sec"], "objects": objects,
            "allocated": allocated}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--turn", choices=("plain", "check"))
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.turn:
        with open(args.out, "w") as f:
            json.dump(turn(args.turn, args.steps), f)
        return 0
    rows = []
    with tempfile.TemporaryDirectory() as d:
        for r in range(args.rounds):
            for i, variant in enumerate(("plain", "check", "check",
                                         "plain")):
                out = os.path.join(d, f"{r}_{i}.json")
                res = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--turn",
                     variant, "--steps", str(args.steps), "--out", out],
                    stdout=subprocess.DEVNULL, timeout=600)
                if res.returncode:
                    print(f"turn {variant} exited {res.returncode}")
                    return 1
                with open(out) as f:
                    row = json.load(f)
                rows.append(row)
                print(f"{variant}: median {row['median_ms']:.2f} ms a step, "
                      f"first {row['first_ms']:.1f} ms; {row['objects']} "
                      f"Python objects, {row['allocated']} bytes on the card "
                      "before the run", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
