#!/usr/bin/env python3
"""B3 (scatter-fused forces) and B2/B4 (neighbour refinement) of two
checkouts of this repository, on the same inputs, timed in turns on one
CUDA card.

  python3 scripts/forces_merge_ab.py OLD_ROOT NEW_ROOT [--rounds 1]

One process, importing OLD_ROOT's ``repro_torch``, makes the inputs once
and saves them under ``NEW_ROOT/build/``: the main path's state after 50
steps at MNIST's shape (``synthetic.mnist_like(n=70000, dim=784, seed=0)``,
the default config), and the same after 50 steps at dim_ld 5, 8 and 32
(``chip_smoke.py``'s phase j); from each, the arguments of one step's
kernel calls, recorded (the refinement gate forced open): B3, B2 HD and LD,
B4 HD and LD (``cand_fused=False``), B4 in one NND iteration, and B2 and B4
at K = 128, C = 64.  Each turn is then a process of its own that imports
one checkout's ``repro_torch`` (its kernels built from that checkout's
sources into its own ``build/``), runs every case once, saves the outputs
and times each case from CUDA graphs (``REPEATS`` replays of a graph of
``REPS`` calls).  A round runs old, new, new, old.  Prints each turn's
times, the card's name and power limit, whether each case's outputs are
bit for bit the other checkout's (else the largest difference relative to
the old output's largest entry), and one JSON line with all of it.
Unpack the older commit with ``git archive`` into a directory that
``.gitignore`` lists, e.g. ``build/parent``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

N, DIM, STEPS = 70_000, 784, 50
WIDTHS = (5, 8, 32)          # phase (j)'s dim_ld beside the main path's 2
REPS, REPEATS = 20, 3


def _import(root):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.core import funcsne, nnd, threefry
    return torch, funcsne, nnd, threefry


def prepare(root: str, path: str) -> int:
    """Make the inputs with ``root``'s kernels; save {case: (op, args, kw)}."""
    torch, funcsne, nnd, threefry = _import(root)
    from repro_torch.data import synthetic
    dev = torch.device("cuda")
    X = torch.from_numpy(synthetic.mnist_like(n=N, dim=DIM, seed=0)[0]).to(dev)
    cfg = funcsne.FuncSNEConfig(n_points=N, dim_hd=DIM)
    hp = funcsne.default_hparams(N, device=dev)
    cases = {}

    def step(cfg_s, st, tag):
        """One step of ``cfg_s`` from ``st`` (gate open), recording the
        first call of each entry point as case ``<entry>_<mode><tag>``."""
        def rec(name, fn):
            def f(*args, **kw):
                key = name
                if name in ("knn_merge_cand", "knn_merge"):
                    key += "_ld" if args[3] is None else "_hd"
                cases.setdefault(key + tag, (name, args, kw))
                return fn(*args, **kw)
            return f
        ops = funcsne.Ops(*[rec(name, fn) for name, fn in
                            zip(funcsne.Ops._fields, funcsne.KERNELS)])
        st = st._replace(ema_new_frac=torch.ones_like(st.ema_new_frac))
        funcsne.funcsne_step(cfg_s, st, X, hp, ops=ops)

    for d in (2,) + WIDTHS:
        cfg_w = dataclasses.replace(cfg, dim_ld=d)
        st = funcsne.init_state(X, cfg_w, seed=0, perplexity=hp.perplexity,
                                device=dev)
        chunk = funcsne.make_chunked_step(
            cfg_w, STEPS, schedule=funcsne.default_schedule, n_iter=500)
        st, _, _ = chunk(st, X, hp)
        tag = "" if d == 2 else f"_d{d}"
        step(cfg_w, st, tag)
        if d in (2, 8):
            step(dataclasses.replace(cfg_w, cand_fused=False), st, tag)
    cfg_k = dataclasses.replace(cfg, k_hd=128, c_hd_non=58)
    for flags in ({}, dict(cand_fused=False)):
        cfg_kf = dataclasses.replace(cfg_k, **flags)
        st = funcsne.init_state(X, cfg_kf, seed=0, perplexity=hp.perplexity,
                                device=dev)
        step(cfg_kf, st, "_k128")
    ncfg = nnd.NNDConfig()
    key = threefry.prng_key(0)
    idx, dist = nnd.nnd_init(key, X, ncfg, device=dev)
    found = {}

    def rec_nnd(*args, **kw):
        found.setdefault("knn_merge_nnd", ("knn_merge", args, kw))
        return funcsne.KERNELS.knn_merge(*args, **kw)
    ops = funcsne.KERNELS._replace(knn_merge=rec_nnd)
    nnd.nnd_step(threefry.fold_in(key, 0), X, idx, dist, ncfg, device=dev,
                 ops=ops)
    cases.update(found)
    # HD at dim_ld 5, 8, 32 and LD at K = 128 repeat the main path's shapes
    keep = {k: v for k, v in cases.items()
            if v[0] in ("ne_forces_scatter", "knn_merge_cand", "knn_merge")
            and "_hd_d" not in k and "_ld_k128" not in k}
    torch.save(keep, path)
    print(json.dumps(sorted(keep)), flush=True)
    return 0


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


def turn(root: str, inputs: str, out: str) -> int:
    """Run and time every case with ``root``'s kernels; save the outputs to
    ``out``; print one JSON line {case: [ms, ...]}."""
    torch, funcsne, _, _ = _import(root)
    cases = torch.load(inputs, weights_only=False)
    res, outs = {}, {}
    for name, (op, args, kw) in sorted(cases.items()):
        fn = getattr(funcsne.KERNELS, op)
        outs[name] = [t.cpu() for t in flat(fn(*args, **kw))]
        res[name] = graph_ms(torch, lambda: fn(*args, **kw))
    torch.save(outs, out)
    print(json.dumps(res), flush=True)
    return 0


def compare(torch, old, new):
    """'bit-identical', or the largest difference relative to the old
    output's largest finite entry (ids and flags: the share that differ)."""
    worst = []
    for a, b in zip(old, new):
        if a.dtype == torch.float32:
            if torch.equal(a.view(torch.int32), b.view(torch.int32)):
                continue
            fin = torch.isfinite(a) & torch.isfinite(b)
            scale = float(a[fin].abs().max()) if fin.any() else 1.0
            same_inf = bool((torch.isfinite(a) == torch.isfinite(b)).all())
            worst.append(f"float max rel {float((a - b)[fin].abs().max()) / max(scale, 1e-30):.3e}"
                         + ("" if same_inf else ", +inf slots differ"))
        elif not torch.equal(a, b):
            worst.append(f"{a.dtype} {float((a != b).float().mean()):.2e} differ")
    return "bit-identical" if not worst else "; ".join(worst)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--mode", choices=("prepare", "turn"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode == "prepare":
        return prepare(args.old, args.inputs)
    if args.mode == "turn":
        return turn(args.old, args.inputs, args.out)
    roots = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    work = os.path.join(roots["new"], "build", "forces_merge_ab")
    os.makedirs(work, exist_ok=True)
    inputs = os.path.join(work, "inputs.pt")
    me = os.path.abspath(__file__)
    res = subprocess.run([sys.executable, me, roots["old"], roots["old"],
                          "--mode", "prepare", "--inputs", inputs],
                         cwd=roots["old"], stdout=subprocess.PIPE, text=True,
                         check=True)
    print(f"inputs: {res.stdout.strip().splitlines()[-1]}", flush=True)
    turns, saved = [], {}
    for rnd in range(args.rounds):
        for i, label in enumerate(("old", "new", "new", "old")):
            out = os.path.join(work, f"{label}_{rnd}_{i}.pt")
            res = subprocess.run([sys.executable, me, roots[label],
                                  roots[label], "--mode", "turn", "--inputs",
                                  inputs, "--out", out], cwd=roots[label],
                                 stdout=subprocess.PIPE, text=True, check=True)
            times = json.loads(res.stdout.strip().splitlines()[-1])
            saved.setdefault(label, out)
            turns.append({"tree": label, "ms": times})
            print(f"{label}: " + "; ".join(
                f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                for k, v in times.items()) + " ms", flush=True)
    import torch
    old, new = (torch.load(saved[t], weights_only=False) for t in ("old", "new"))
    same = {name: compare(torch, old[name], new[name]) for name in old}
    for name, verdict in same.items():
        best = {t: min(min(x["ms"][name]) for x in turns if x["tree"] == t)
                for t in ("old", "new")}
        print(f"{name}: new against old {verdict}; best ms old "
              f"{best['old']:.4f}, new {best['new']:.4f} "
              f"({best['new'] / best['old']:.3f}x)", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({"roots": roots, "card": card, "outputs": same,
                      "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
