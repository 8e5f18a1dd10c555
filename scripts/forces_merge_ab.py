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
at K = 128, C = 64.  At each of dim_ld 2, 5, 8 and 32 it also records B5
(``ne_forces_gather``) from one ``scatter_fused=False`` step and B7's three
calls (``ne_forces``: K 32, 16, 16) from one ``gather_fused=False`` step,
as one case each, and three timing-only cases: B5 emitting no edge
(``_noemit``, the cost of the edge stores) and B7's K 32 and first K 16
call alone (``_k32``, ``_k16``, the cost of a half-warp that idles).  Each
turn is then a process of its own that imports one checkout's
``repro_torch`` (its kernels built from that checkout's sources into its
own ``build/``), runs every case once, saves the outputs and times each
case from CUDA graphs (``REPEATS`` replays of a graph of ``REPS`` calls).
A round runs old, new, new, old.  Prints each turn's times; for each case
whether its outputs are bit for bit the other checkout's (int32 views;
else the largest difference relative to the old output's largest entry)
and each tree's best time and their ratio; for B5's and B7's cases also
the width, the edges, the bytes each must move (inputs read once, outputs
written once), the bound, each tree's effective TB/s, the launches a step
and the launch counters (routes) each tree moved; the registers and
spills of each tree's force kernels (B3, B5, B7: its build log); the
card's name and power limit; and one JSON line with all of it.
Unpack the older commit with ``git archive`` into a directory that
``.gitignore`` lists, e.g. ``build/parent``.  The turns, the timing and
the comparison are ``ab_common``'s.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import ab_common

N, DIM, STEPS = 70_000, 784, 50
WIDTHS = (5, 8, 32)          # phase (j)'s dim_ld beside the main path's 2
HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12   # one H100 SXM


def _import(root):
    ab_common.import_root(root)
    import torch
    from repro_torch.core import funcsne, nnd, threefry
    return torch, funcsne, nnd, threefry


def prepare(root: str, path: str) -> int:
    """Make the inputs with ``root``'s kernels; save {case: (op, args, kw,
    stats)} and print {case: stats} (B5's and B7's cases only, else null)."""
    torch, funcsne, nnd, threefry = _import(root)
    from repro_torch.data import synthetic
    dev = torch.device("cuda")
    X = torch.from_numpy(synthetic.mnist_like(n=N, dim=DIM, seed=0)[0]).to(dev)
    cfg = funcsne.FuncSNEConfig(n_points=N, dim_hd=DIM)
    hp = funcsne.default_hparams(N, device=dev)
    cases = {}

    def step(cfg_s, st, tag):
        """One step of ``cfg_s`` from ``st`` (gate open), recording the
        first call of each entry point as case ``<entry>_<mode><tag>``, and
        B7's three calls of the step as ``ne_forces_<i><tag>``."""
        n_b7 = [0]

        def rec(name, fn):
            def f(*args, **kw):
                key = name
                if name in ("knn_merge_cand", "knn_merge"):
                    key += "_ld" if args[3] is None else "_hd"
                elif name == "ne_forces":
                    key += f"_{n_b7[0]}"
                    n_b7[0] += 1
                cases.setdefault(key + tag, (name, args, kw))
                return fn(*args, **kw)
            return f
        ops = funcsne.Ops(*[rec(name, fn) for name, fn in
                            zip(funcsne.Ops._fields, funcsne.KERNELS)])
        st = st._replace(ema_new_frac=torch.ones_like(st.ema_new_frac))
        funcsne.funcsne_step(cfg_s, st, X, hp, ops=ops)

    def force_cases(tag):
        """B5 and B7 of this width as cases: B5's call of the
        scatter_fused=False step (``ne_forces_gather``) and the same call
        emitting no edge (``_noemit``, timing only); B7's three calls of the
        gather_fused=False step as one case (``ne_forces``), and its K 32
        and first K 16 calls alone (``_k32``, ``_k16``, timing only)."""
        op, args, kw = cases.pop("ne_forces_gather" + tag)
        out = {"ne_forces_gather" + tag: (op, args, kw, 1)}
        kw_n = dict(kw, emit_edges=(False,) * len(kw["emit_edges"]))
        out["ne_forces_gather_noemit" + tag] = (op, args, kw_n, 0)
        b7 = [cases.pop(f"ne_forces_{i}" + tag) for i in range(3)]
        out["ne_forces" + tag] = ("calls", b7, {}, 3)
        out["ne_forces_k32" + tag] = b7[0] + (0,)
        out["ne_forces_k16" + tag] = b7[1] + (0,)
        return out

    forces = {}
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
        step(dataclasses.replace(cfg_w, scatter_fused=False), st, tag)
        step(dataclasses.replace(cfg_w, gather_fused=False), st, tag)
        forces.update(force_cases(tag))
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
    keep = {k: v + (None,) for k, v in cases.items()
            if v[0] in ("ne_forces_scatter", "knn_merge_cand", "knn_merge")
            and "_hd_d" not in k and "_ld_k128" not in k}
    for name, (op, args, kw, launches) in forces.items():
        keep[name] = (op, args, kw, force_stats(torch, funcsne, op, args, kw,
                                                launches))
    torch.save(keep, path)
    print(json.dumps({k: v[3] for k, v in sorted(keep.items())}), flush=True)
    return 0


def force_stats(torch, funcsne, op, args, kw, launches):
    """A B5 or B7 case's work: its width, edges, the bytes it must move
    (each input read once, each output written once) and its bound, the
    larger of those bytes over the HBM rate and (12 + 4 d) flops an edge
    (``chip_smoke.py``'s count) over the float32 rate; ``launches``: its
    kernel's launches a step of the path that runs it (0: timing only)."""
    calls = args if op == "calls" else [(op, args, kw)]
    seen, nbytes, edges = set(), 0, 0
    for o, a, k in calls:
        outs = ab_common.flat(getattr(funcsne.KERNELS, o)(*a, **k))
        for t in [*a, *outs]:
            if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                nbytes += t.numel() * t.element_size()
        edges += a[2].numel() if o == "ne_forces" else a[3].numel()
    d = calls[0][1][0].shape[1]
    flops = (12.0 + 4.0 * d) * edges
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
    return {"d": d, "edges": edges, "bytes": nbytes, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / FP32_FLOPS_PER_S else "operations",
            "launches": launches}


def main() -> int:
    roots, prepared, turns, same = ab_common.run(__file__, __doc__, prepare,
                                                 "forces_merge_ab")
    stats = json.loads(prepared)
    for name, verdict in same.items():
        best = ab_common.best(turns, name)
        line = (f"{name}: new against old {verdict}; best ms old "
                f"{best['old']:.4f}, new {best['new']:.4f} "
                f"({best['new'] / best['old']:.3f}x)")
        s = stats.get(name)
        if s:
            routes = {t: next(x["routes"][name] for x in turns
                              if x["tree"] == t) for t in ("old", "new")}
            gb = s["bytes"] / 1e9
            line += (f"; d {s['d']}, {s['edges']} edges, {gb:.4f} GB, bound "
                     f"{s['bound_ms']:.4f} ms by {s['bound_by']}, TB/s old "
                     f"{gb / best['old']:.3f} new {gb / best['new']:.3f}, "
                     f"launches a step {s['launches']}; routes old "
                     f"{routes['old']}, new {routes['new']}")
        print(line, flush=True)
    usage = {t: ab_common.kernel_usage(r, "forces_")
             for t, r in roots.items()}
    for t, u in usage.items():
        for entry, res in sorted(u.items()):
            print(f"{t} {entry}: {res}", flush=True)
    card = ab_common.card()
    print(card, flush=True)
    print(json.dumps({"roots": roots, "card": card, "stats": stats,
                      "outputs": same, "usage": usage, "turns": turns}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
