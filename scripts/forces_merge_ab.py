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


def _import(root):
    ab_common.import_root(root)
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


def main() -> int:
    roots, prepared, turns, same = ab_common.run(__file__, __doc__, prepare,
                                                 "forces_merge_ab")
    print(f"inputs: {prepared}", flush=True)
    for name, verdict in same.items():
        best = ab_common.best(turns, name)
        print(f"{name}: new against old {verdict}; best ms old "
              f"{best['old']:.4f}, new {best['new']:.4f} "
              f"({best['new'] / best['old']:.3f}x)", flush=True)
    card = ab_common.card()
    print(card, flush=True)
    print(json.dumps({"roots": roots, "card": card, "outputs": same,
                      "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
