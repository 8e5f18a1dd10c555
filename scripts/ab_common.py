"""What the A/B scripts of this directory share: each times recorded kernel
calls of two checkouts of this repository on one CUDA card, in turns.

A script makes its cases in a ``prepare`` process with the older checkout
(a dict {name: (op, args, kw, ...)} saved with ``torch.save``); ``run``
then starts one ``turn`` process per checkout and turn, old, new, new, old
for each round.  A turn imports its checkout's ``repro_torch`` (its kernels
built from that checkout's sources into its own ``build/``), runs every
case once through ``funcsne.KERNELS`` (``case_fn``), saves the outputs,
notes the launch counters each case moved and times each case from CUDA
graphs (``REPEATS`` replays of a graph of ``REPS`` calls).
``kernel_usage`` reads a checkout's registers and spills from its build
log.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys

REPS, REPEATS = 20, 3


def import_root(root):
    """``root``'s ``repro_torch`` on the path, first."""
    sys.path.insert(0, os.path.join(root, "src"))


def graph_ms(torch, fn):
    """ms per call of ``fn`` replayed from a CUDA graph of REPS calls,
    REPEATS replays."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(REPS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(REPEATS):
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / REPS)
    return times


def flat(v):
    return [t for x in v for t in flat(x)] if isinstance(v, (tuple, list)) \
        else [v]


def case_fn(funcsne, op, args, kw):
    """The call of one case: ``funcsne.KERNELS.<op>(*args, **kw)``, or with
    ``op`` "calls" the recorded calls ``args`` = [(op, args, kw), ...] run
    in order as one case (B7's three launches of a step)."""
    if op == "calls":
        fns = [(getattr(funcsne.KERNELS, o), a, k) for o, a, k in args]
        return lambda: [f(*a, **k) for f, a, k in fns]
    fn = getattr(funcsne.KERNELS, op)
    return lambda: fn(*args, **kw)


def turn(root: str, inputs: str, out: str) -> int:
    """Run and time every case with ``root``'s kernels; save the outputs to
    ``out``; print one JSON line {"ms": {case: [ms, ...]}, "routes": {case:
    [launch counters moved]}}."""
    import_root(root)
    import torch
    from repro_torch import kernels
    from repro_torch.core import funcsne
    cases = torch.load(inputs, weights_only=False)
    res, outs, routes = {}, {}, {}
    for name, (op, args, kw, *_) in sorted(cases.items()):
        fn = case_fn(funcsne, op, args, kw)
        kernels.reset_launches()
        outs[name] = [t.cpu() for t in flat(fn()) if t is not None]
        routes[name] = sorted(k for k, v in kernels.LAUNCHES.items() if v)
        res[name] = graph_ms(torch, fn)
    torch.save(outs, out)
    print(json.dumps({"ms": res, "routes": routes}), flush=True)
    return 0


def compare(torch, old, new):
    """'bit-identical', or what differs: floats compared as int32 views
    (the share that differ and the largest difference relative to the old
    output's largest finite entry), ids and flags by the share that
    differ."""
    worst = []
    for a, b in zip(old, new):
        if a.dtype == torch.float32:
            ai, bi = a.view(torch.int32), b.view(torch.int32)
            if torch.equal(ai, bi):
                continue
            fin = torch.isfinite(a) & torch.isfinite(b)
            scale = float(a[fin].abs().max()) if fin.any() else 1.0
            rel = (float((a - b)[fin].abs().max()) / max(scale, 1e-30)
                   if fin.any() else 0.0)
            same_inf = bool((torch.isfinite(a) == torch.isfinite(b)).all())
            worst.append(f"float {float((ai != bi).float().mean()):.2e} "
                         f"differ, max rel {rel:.3e}"
                         + ("" if same_inf else ", +inf slots differ"))
        elif not torch.equal(a, b):
            worst.append(f"{a.dtype} {float((a != b).float().mean()):.2e} "
                         "differ")
    return "bit-identical" if not worst else "; ".join(worst)


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_usage(root, pattern):
    """{kernel entry: ptxas's registers and spills} for the entries of
    ``root``'s newest kernel build whose mangled name holds ``pattern``
    (the build's ``-Xptxas -v`` log, ``build/build_<tag>.log``)."""
    logs = sorted(glob.glob(os.path.join(root, "build", "build_*.log")),
                  key=os.path.getmtime)
    if not logs:
        return {}
    usage, entry = {}, None
    with open(logs[-1]) as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1) if pattern in m.group(1) else None
            elif entry and "spill stores" in line:
                usage[entry] = line.strip()
            elif entry and "Used" in line and "registers" in line:
                usage[entry] = (re.search(r"Used \d+ registers", line)
                                .group(0) + "; " + usage.get(entry, ""))
    return usage


def best(turns, name):
    """{tree: its best ms of case ``name`` over its turns}."""
    return {t: min(min(x["ms"][name]) for x in turns if x["tree"] == t)
            for t in ("old", "new")}


def run(script, doc, prepare, work_name):
    """The command line of an A/B script: ``script OLD_ROOT NEW_ROOT
    [--rounds N]``.  Runs ``prepare(old_root, inputs_path)`` in a process
    of its own, then the turns; returns None inside a child process, else
    (roots, the prepare process's last output line, the turns, {case:
    compare's verdict of new against old})."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--mode", choices=("prepare", "turn"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode == "prepare":
        sys.exit(prepare(args.old, args.inputs))
    if args.mode == "turn":
        sys.exit(turn(args.old, args.inputs, args.out))
    roots = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    work = os.path.join(roots["new"], "build", work_name)
    os.makedirs(work, exist_ok=True)
    inputs = os.path.join(work, "inputs.pt")
    me = os.path.abspath(script)
    res = subprocess.run([sys.executable, me, roots["old"], roots["old"],
                          "--mode", "prepare", "--inputs", inputs],
                         cwd=roots["old"], stdout=subprocess.PIPE, text=True,
                         check=True)
    prepared = res.stdout.strip().splitlines()[-1]
    turns, saved = [], {}
    for rnd in range(args.rounds):
        for i, label in enumerate(("old", "new", "new", "old")):
            out = os.path.join(work, f"{label}_{rnd}_{i}.pt")
            res = subprocess.run([sys.executable, me, roots[label],
                                  roots[label], "--mode", "turn", "--inputs",
                                  inputs, "--out", out], cwd=roots[label],
                                 stdout=subprocess.PIPE, text=True, check=True)
            got = json.loads(res.stdout.strip().splitlines()[-1])
            saved.setdefault(label, out)
            turns.append({"tree": label, **got})
            print(f"{label}: " + "; ".join(
                f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                for k, v in got["ms"].items()) + " ms", flush=True)
    import torch
    old, new = (torch.load(saved[t], weights_only=False) for t in ("old", "new"))
    same = {name: compare(torch, old[name], new[name]) for name in old}
    return roots, prepared, turns, same
