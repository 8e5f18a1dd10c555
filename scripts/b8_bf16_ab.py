#!/usr/bin/env python3
"""B8's bf16 kernel of two checkouts of this repository, timed in turns on
one CUDA card.

  python3 scripts/b8_bf16_ab.py OLD_ROOT NEW_ROOT [--rounds 2]

Each turn is a process of its own that imports one checkout's
``repro_torch`` (its kernels built from that checkout's sources into its
own ``build/``), checks the kernel that checkout's ``kernel_route`` names
for bf16 at each shape (``launch_wgmma``, or ``launch_simt`` where the
tensor-core kernel has no instance) against the plain version on phase
(h)'s bf16 shapes of ``chip_smoke.py`` (MusicGen-large's prefill, Qwen2-7B's
at 4k, Gemma2-2b's global layer at 8k) and phase (p3)'s (Zamba2-2.7B's
shared block, D 80, in the model's (B, S, H, D) layout through strides),
inputs from seed 7, and times it with CUDA events.  A round runs old, new,
new, old, so a drift of the card's clocks over the call falls on both.
Prints one line a turn (each shape's route, times and the tensor-core
kernel's registers and spills from the build log), then the card's name
and power limit, then one JSON line with every turn's times.  Unpack the
older commit with ``git archive`` into a directory that ``.gitignore``
lists, e.g. ``build/parent``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ab_common  # noqa: E402

# (name, B, Hq, Hkv, S, D, softcap, window, timing reps, layout)
SHAPES = (
    ("musicgen", 4, 32, 32, 1500, 64, 0.0, 0, 200, "bhsd"),
    ("qwen2", 1, 28, 4, 4096, 128, 0.0, 0, 100, "bhsd"),
    ("gemma2_w0", 1, 8, 4, 8192, 256, 50.0, 0, 20, "bhsd"),
    ("zamba2", 2, 32, 32, 2048, 80, 0.0, 0, 20, "bshd"),
)
REPEATS = 3          # timed runs of ``reps`` calls each, per shape and turn


def worker(root: str) -> int:
    """Time one checkout's kernels; print one JSON line {"ms": {name: [ms,
    ...]}, "route": {name: route}, "usage": {entry: registers}}."""
    ab_common.import_root(root)
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    res, route = {}, {}
    for name, b, hq, hkv, s_len, d, cap, win, reps, layout in SHAPES:
        shape = ((lambda h: (b, s_len, h, d)) if layout == "bshd" else
                 (lambda h: (b, h, s_len, d)))
        q, k, v = (torch.randn(shape(h), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (hq, hkv, hkv))
        if layout == "bshd":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out = torch.empty_like(q)
        kw = dict(scale=d ** -0.5, softcap=cap, window=win)
        route[name] = ops.kernel_route(torch.bfloat16, d, d)
        launch = getattr(ops, f"launch_{route[name]}")
        launch(q, k, v, out, **kw)
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
                launch(q, k, v, out, **kw)
            t1.record()
            torch.cuda.synchronize()
            res[name].append(t0.elapsed_time(t1) / reps)
        del q, k, v, out, want, g, tol
    print(json.dumps({"ms": res, "route": route, "usage":
                      ab_common.kernel_usage(root, "flash_wgmma_kernel")}),
          flush=True)
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
            got = json.loads(res.stdout.strip().splitlines()[-1])
            turns.append({"tree": label, **got})
            print(f"{label}: " + "; ".join(
                f"{k} ({got['route'][k]}) " + " / ".join(f"{t:.4f}" for t in v)
                for k, v in got["ms"].items()) + " ms; "
                + "; ".join(got["usage"].values()), flush=True)
    print(ab_common.card(), flush=True)
    print(json.dumps({"roots": roots, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
