#!/usr/bin/env python3
"""B8's bf16 tensor-core kernel of two checkouts of this repository, timed
in turns on one CUDA card.

  python3 scripts/b8_bf16_ab.py OLD_ROOT NEW_ROOT [--rounds 2]

Each turn is a process of its own that imports one checkout's
``repro_torch`` (its kernels built from that checkout's sources into its
own ``build/``), checks ``launch_wgmma`` against the plain version on
phase (h)'s bf16 shapes of ``chip_smoke.py`` (MusicGen-large's prefill,
Qwen2-7B's at 4k, Gemma2-2b's global layer at 8k; inputs from seed 7) and
times it with CUDA events.  A round runs old, new, new, old, so a drift of
the card's clocks over the call falls on both.  Prints one line a turn,
then the card's name and power limit, then one JSON line with every
turn's times.  Unpack the older commit with ``git archive`` into a
directory that ``.gitignore`` lists, e.g. ``build/parent``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (name, B, Hq, Hkv, S, D, softcap, window, timing reps)
SHAPES = (
    ("musicgen", 4, 32, 32, 1500, 64, 0.0, 0, 200),
    ("qwen2", 1, 28, 4, 4096, 128, 0.0, 0, 100),
    ("gemma2_w0", 1, 8, 4, 8192, 256, 50.0, 0, 20),
)
REPEATS = 3          # timed runs of ``reps`` calls each, per shape and turn


def worker(root: str) -> int:
    """Time one checkout's kernel; print one JSON line {name: [ms, ...]}."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    res = {}
    for name, b, hq, hkv, s_len, d, cap, win, reps in SHAPES:
        q, k, v = (torch.randn((b, h, s_len, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (hq, hkv, hkv))
        out = torch.empty_like(q)
        kw = dict(scale=d ** -0.5, softcap=cap, window=win)
        ops.launch_wgmma(q, k, v, out, **kw)
        want = flash_attention_ref(q, k, v, softcap=cap, window=win).float()
        g = out.float()
        tol = 1e-5 * float(want.abs().max()) + 2.0 ** -7 * torch.maximum(
            g.abs(), want.abs())
        if not bool(((g - want).abs() <= tol).all()):
            print(f"{root}: {name} differs from the plain version",
                  file=sys.stderr)
            return 1
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        res[name] = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0.record()
            for _ in range(reps):
                ops.launch_wgmma(q, k, v, out, **kw)
            t1.record()
            torch.cuda.synchronize()
            res[name].append(t0.elapsed_time(t1) / reps)
        del q, k, v, out, want, g, tol
    print(json.dumps(res), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.old)
    roots = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    turns = []
    for _ in range(args.rounds):
        for label in ("old", "new", "new", "old"):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), roots[label],
                 roots[label], "--worker"], cwd=roots[label],
                stdout=subprocess.PIPE, text=True, check=True)
            times = json.loads(res.stdout.strip().splitlines()[-1])
            turns.append({"tree": label, "ms": times})
            print(f"{label}: " + "; ".join(
                f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                for k, v in times.items()) + " ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({"roots": roots, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
