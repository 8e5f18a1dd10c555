#!/usr/bin/env python3
"""B8's bf16 backward of two checkouts of this repository, timed in turns on
one CUDA card.

  python3 scripts/b8_bwd_ab.py OLD_ROOT NEW_ROOT [--rounds 1]

Each turn is a process of its own that imports one checkout's
``repro_torch`` (its kernels built from that checkout's sources into its
own ``build/``) and runs ``launch_bwd`` -- the backward kernel that
checkout routes bf16 to -- at every bf16 shape of ``chip_smoke.py``'s
``BWD_CASES`` (MusicGen-large, Qwen2-7B at 4k, Gemma2-2b's local and
global layers, DeepSeek-V2's MLA prefill, Zamba2-2.7B's shared block), in
the model's (B, S, H, D) layout through strides, inputs from seed 31 and
the forward's output from that checkout's B8.  Two checkouts sum in
another order, so their gradients are not compared bit for bit: each turn
holds its own against ``flash_attention_bwd_ref`` (phase (q1)'s check:
TOL_ATTN_BWD_F32 of the largest |entry| plus 2^-7 of the value) and
against a second launch of its own, bit for bit, then times it with CUDA
events, and each of its kernels' device time in one more call under the
profiler.  A round runs old, new, new, old, so a drift of the card's clocks
over the call falls on both.  Prints one line a turn (each shape's route,
times and split by kernel, and the registers and spills of the backward's
kernels from the build log), then the card's name and power limit, then
one JSON line with every turn's times.  B8's forward output of the first
old and the first new turn is compared bit for bit at each shape (the two
checkouts' forward kernels on the same inputs).

``--q3 N`` then times N rounds of MusicGen-large's train step in turns
(the model, batch and optimizer of ``chip_smoke.py``'s phase (q3): 48
layers, B 2 x 1,024, bf16 compute, AdamW), each turn a process of its
own: Q3_STEPS steps, the first a warm-up, the host's ms of each later
step around a synchronised call, the losses and the launch counters.
``--worker`` runs one turn of OLD_ROOT alone.  Unpack the older commit
with ``git archive`` into a directory that ``.gitignore`` lists, e.g.
``build/parent``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ab_common  # noqa: E402

# (name, B, S, Hq, Hkv, D, Dv, softcap, window, timing reps): the bf16 rows
# of chip_smoke.py's BWD_CASES
SHAPES = (
    ("musicgen", 2, 1024, 32, 32, 64, 64, 0.0, 0, 20),
    ("qwen2", 1, 4096, 28, 4, 128, 128, 0.0, 0, 5),
    ("gemma2_w1024", 2, 2048, 8, 4, 256, 256, 50.0, 1024, 5),
    ("gemma2_w0", 2, 2048, 8, 4, 256, 256, 50.0, 0, 5),
    ("deepseek", 2, 1024, 128, 128, 192, 128, 0.0, 0, 5),
    ("zamba2", 2, 2048, 32, 32, 80, 80, 0.0, 0, 5),
)
REPEATS = 3          # timed runs of ``reps`` calls each, per shape and turn
TOL_ATTN_BWD_F32 = 1e-4
Q3_STEPS = 6         # train steps a (q3) turn, the first a warm-up


def worker(root: str, fwd_out: str | None) -> int:
    """Check and time one checkout's backward; print one JSON line {"ms":
    {name: [ms, ...]}, "route": {name: launch counter}, "err": {name: max
    abs err}, "split": {name: {kernel: device ms of one call}}, "usage":
    {entry: registers}}; save B8's forward outputs by name to ``fwd_out``
    (``torch.save``), if given."""
    ab_common.import_root(root)
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    res, route, errs, split, fwd = {}, {}, {}, {}, {}
    for name, b, s_len, hq, hkv, d, dv, cap, win, reps in SHAPES:
        q, k, v = (torch.randn((b, s_len, h, w), generator=gen, device=dev)
                   .to(torch.bfloat16) for h, w in ((hq, d), (hkv, d),
                                                    (hkv, dv)))
        dout = torch.randn((b, s_len, hq, dv), generator=gen,
                           device=dev).to(torch.bfloat16)
        out = torch.empty_like(dout)
        args = [t.transpose(1, 2) for t in (q, k, v, out, dout)]
        kw = dict(scale=d ** -0.5, softcap=cap, window=win)
        ops.launch(*args[:4], **kw)
        fwd[name] = out.cpu()
        kernels.reset_launches()
        got = ops.launch_bwd(*args, **kw)
        torch.cuda.synchronize()
        route[name] = [k_ for k_, n in kernels.LAUNCHES.items() if n]
        want = flash_attention_bwd_ref(*args, **kw)
        errs[name] = []
        for g_, w_ in zip(got, want):
            g, w = g_.float(), w_.float()
            tol = TOL_ATTN_BWD_F32 * float(w.abs().max()) + \
                2.0 ** -7 * torch.maximum(g.abs(), w.abs())
            err = (g - w).abs()
            errs[name].append(float(err.max()))
            if not bool((err <= tol).all()):
                print(f"{root}: {name} differs from the plain version "
                      f"(max abs err {float(err.max())})", file=sys.stderr)
                return 1
        again = ops.launch_bwd(*args, **kw)
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            print(f"{root}: {name}: a second launch differs", file=sys.stderr)
            return 1
        del want, again
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        res[name] = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0.record()
            for _ in range(reps):
                ops.launch_bwd(*args, **kw)
            t1.record()
            torch.cuda.synchronize()
            res[name].append(t0.elapsed_time(t1) / reps)
        # each kernel's device time in one call (profiler, by kernel name)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.launch_bwd(*args, **kw)
            torch.cuda.synchronize()
        split[name] = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                part = next((p for p in ("pre", "dkdv", "dq")
                             if f"bwd_{p}_kernel" in e.name()), "other")
                split[name][part] = (split[name].get(part, 0.0)
                                     + e.duration_ns() / 1e6)
        del q, k, v, out, dout, args, got
        torch.cuda.empty_cache()
    if fwd_out:
        torch.save(fwd, fwd_out)
    print(json.dumps({"ms": res, "route": route, "err": errs, "split": split,
                      "usage": ab_common.kernel_usage(root, "bwd_")}),
          flush=True)
    return 0


def q3_worker(root: str) -> int:
    """MusicGen-large's train step with ``root``'s kernels (the model, batch
    and optimizer of ``chip_smoke.py``'s (q3)); print one JSON line
    {"ms": [ms of each step after the first], "loss": [...], "launches":
    {counter: n}}."""
    import time
    ab_common.import_root(root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch import kernels
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.launch.train import make_data_fn
    from repro_torch.models.transformer import LMModel

    dev = torch.device("cuda")
    cfg = get_arch("musicgen-large")
    model = LMModel(cfg)
    params = model.init_params(0, device=dev)
    batch = make_data_fn(cfg, 2, 1024, dev)(0)
    opt = make_optimizer(cfg, peak_lr=1e-5, warmup=0, total=Q3_STEPS)
    step_fn = make_train_step(model, opt)
    opt_state = opt.init(params)
    kernels.reset_launches()
    ms, losses = [], []
    for _ in range(Q3_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    print(json.dumps({"ms": ms[1:], "loss": losses, "launches": {
        k: n for k, n in kernels.LAUNCHES.items() if n}}), flush=True)
    return 0


def q3_rounds(roots: dict, rounds: int) -> list:
    """(q3)'s step of each checkout in turns, old, new, new, old a round."""
    turns = []
    for _ in range(rounds):
        for label in ("old", "new", "new", "old"):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), roots[label],
                 roots[label], "--worker", "--q3", "1"],
                cwd=roots[label], stdout=subprocess.PIPE, text=True,
                check=True)
            got = json.loads(res.stdout.strip().splitlines()[-1])
            turns.append({"tree": label, **got})
            print(f"q3 {label}: " + " / ".join(f"{t:.1f}" for t in got["ms"])
                  + f" ms a step; losses {got['loss'][0]:.5f} -> "
                  f"{got['loss'][-1]:.5f}; launches {got['launches']}",
                  flush=True)
    med = {t: sorted(x for tr in turns if tr["tree"] == t
                     for x in tr["ms"]) for t in ("old", "new")}
    print("q3 median ms a step: " + ", ".join(
        f"{t} {v[len(v) // 2]:.1f}" for t, v in med.items()), flush=True)
    return turns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--q3", type=int, default=0,
                    help="rounds of (q3)'s train step after the kernels")
    ap.add_argument("--fwd-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return (q3_worker(args.old) if args.q3
                else worker(args.old, args.fwd_out))
    roots = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    work = os.path.join(roots["new"], "build", "b8_bwd_ab")
    os.makedirs(work, exist_ok=True)
    turns = []
    for rnd in range(args.rounds):
        for i, label in enumerate(("old", "new", "new", "old")):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), roots[label],
                 roots[label], "--worker", "--fwd-out",
                 os.path.join(work, f"{label}_{rnd}_{i}.pt")],
                cwd=roots[label], stdout=subprocess.PIPE, text=True,
                check=True)
            got = json.loads(res.stdout.strip().splitlines()[-1])
            turns.append({"tree": label, **got})
            print(f"{label}: " + "; ".join(
                f"{k} ({'+'.join(got['route'][k])}) "
                + " / ".join(f"{t:.4f}" for t in v) + " ms ("
                + ", ".join(f"{p} {t:.4f}" for p, t in got["split"][k].items())
                + ")" for k, v in got["ms"].items()), flush=True)
            for entry, use in sorted(got["usage"].items()):
                print(f"  {entry}: {use}", flush=True)
    best = {t: {name: min(min(x["ms"][name]) for x in turns
                          if x["tree"] == t) for name, *_ in SHAPES}
            for t in ("old", "new")}
    print("new / old, best of each: " + "; ".join(
        f"{name} {best['new'][name] / best['old'][name]:.4f}"
        for name, *_ in SHAPES), flush=True)
    import torch
    old, new = (torch.load(os.path.join(work, f"{t}_0_{i}.pt"))
                for t, i in (("old", 0), ("new", 1)))
    same = [name for name in old if torch.equal(old[name], new[name])]
    print(f"B8's forward output bit-identical between the checkouts at "
          f"{len(same)} of {len(old)} shapes"
          + ("" if len(same) == len(old) else
             f" (differs at {sorted(set(old) - set(same))})"), flush=True)
    q3 = q3_rounds(roots, args.q3) if args.q3 else []
    print(ab_common.card(), flush=True)
    print(json.dumps({"roots": roots, "turns": turns, "q3": q3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
