#!/usr/bin/env python3
"""B2 and B4 (neighbour refinement) on wide rows, of two checkouts of this
repository, on the same inputs, timed in turns on one CUDA card.

  python3 scripts/merge_wide_ab.py OLD_ROOT NEW_ROOT [--rounds 1]

One process, importing OLD_ROOT's ``repro_torch``, makes the inputs once
and saves them under ``NEW_ROOT/build/``.  At MNIST's shape
(``synthetic.mnist_like(n=70000, dim=784, seed=0)``, rows sorted by class,
the default config) it records these calls (the refinement gate forced
open):

  b2_hd          B2 HD after the main path's 500 steps (chip_smoke's phase e)
  b4_hd          B4 HD of ``cand_fused=False`` from that state (phase f)
  b4_nnd_first   B4 in NND's first iteration (phase g's timed call)
  b4_nnd_late    B4 in NND's last iteration of NND_ITERS (phase g's run)
  b2_k128        B2 at K = 128, C = 64 from ``init_state`` (phase j)
  b4_k128        B4 at K = 128, C = 64, ``cand_fused=False`` (phase j)
  b2_ld_m32      B2 LD at dim_ld 32 after a 50-step chunk (phase j)
  b2_hd_m783     b2_hd on the first 783 columns of X (M % 4 != 0)
  b4_hd_m783     b4_hd on the same 783 columns

and each of them but the last two again with ``_perm``: the same work
with the class-sorted locality taken away.  For B4 the rows of X are
permuted by a fixed seed and every id (queries, lists, candidates) is
mapped through the permutation.  B2 draws its candidates from a hash of the row id, which no
mapping keeps, so for B2 the rows are processed in that permuted order
instead (the queries and every per-row table reordered; the same pairs of
rows are scored, none of them in the class-sorted order).  Two more cases
hold the rescore mode on wide rows, which no main path runs there: b4_hd
and b4_k128 with the current rows scored again (``cur_valid`` drawn from a
fixed seed, 80% valid; ``_rescore``).

Each turn is then a process of its own that imports one checkout's
``repro_torch`` (its kernels built from that checkout's sources into its
own ``build/``), runs every case once, saves the outputs and times each
case from CUDA graphs (``ab_common``: ``REPEATS`` replays of a graph of
``REPS`` calls).  A round runs old, new, new, old.  Prints, for each case,
the rows it scores (new candidates, plus the current rows in rescore
mode), the bytes it gathers (scored rows x M x 4, the B query rows x M x 4, and the lists:
ids, distances, candidate blocks or table slots read, outputs written),
the effective rate (those bytes over the best time), the best time of each
tree and whether the outputs are bit for bit the old tree's (ids,
distances as int32 views, ``improved``); the card's name and power limit;
and one JSON line with all of it.  Unpack the older commit with ``git
archive`` into a directory that ``.gitignore`` lists, e.g. ``build/parent``.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import ab_common

N, DIM, STEPS, CHUNK = 70_000, 784, 500, 50
NND_ITERS = 150              # chip_smoke's phase (g): the run's length
PERM_SEED = 7
WARP_ONLY = ("b2_hd_m783", "b4_hd_m783")   # no _perm twins


def _import(root):
    ab_common.import_root(root)
    import torch
    from repro_torch.core import funcsne, knn, nnd, threefry
    return torch, funcsne, knn, nnd, threefry


def prepare(root: str, path: str) -> int:
    """Make the inputs with ``root``'s kernels; save {case: (op, args, kw,
    stats)}."""
    torch, funcsne, knn, nnd, threefry = _import(root)
    from repro_torch.data import synthetic
    dev = torch.device("cuda")
    X = torch.from_numpy(synthetic.mnist_like(n=N, dim=DIM, seed=0)[0]).to(dev)
    cfg = funcsne.FuncSNEConfig(n_points=N, dim_hd=DIM)
    hp = funcsne.default_hparams(N, device=dev)
    cases = {}

    def step(cfg_s, st, names):
        """One step of ``cfg_s`` from ``st`` (gate open), recording the
        first HD / LD call of B2 / B4 as the case ``names`` gives it."""
        def rec(name, fn):
            def f(*args, **kw):
                mode = "ld" if args[3] is None else "hd"
                if (name, mode) in names:
                    cases.setdefault(names[(name, mode)], (name, args, kw))
                return fn(*args, **kw)
            return f
        ops = funcsne.Ops(*[rec(name, fn) for name, fn in
                            zip(funcsne.Ops._fields, funcsne.KERNELS)])
        st = st._replace(ema_new_frac=torch.ones_like(st.ema_new_frac))
        funcsne.funcsne_step(cfg_s, st, X, hp, ops=ops)

    st = funcsne.init_state(X, cfg, seed=0, perplexity=hp.perplexity,
                            device=dev)
    chunk = funcsne.make_chunked_step(cfg, CHUNK,
                                      schedule=funcsne.default_schedule,
                                      n_iter=STEPS)
    for _ in range(STEPS // CHUNK):
        st, _, _ = chunk(st, X, hp)
    step(cfg, st, {("knn_merge_cand", "hd"): "b2_hd"})
    step(dataclasses.replace(cfg, cand_fused=False), st,
         {("knn_merge", "hd"): "b4_hd"})
    cfg_32 = dataclasses.replace(cfg, dim_ld=32)
    st = funcsne.init_state(X, cfg_32, seed=0, perplexity=hp.perplexity,
                            device=dev)
    st, _, _ = funcsne.make_chunked_step(
        cfg_32, CHUNK, schedule=funcsne.default_schedule, n_iter=STEPS)(
            st, X, hp)
    step(cfg_32, st, {("knn_merge_cand", "ld"): "b2_ld_m32"})
    cfg_k = dataclasses.replace(cfg, k_hd=128, c_hd_non=58)
    for flags, op, name in (({}, "knn_merge_cand", "b2_k128"),
                            (dict(cand_fused=False), "knn_merge", "b4_k128")):
        cfg_kf = dataclasses.replace(cfg_k, **flags)
        st = funcsne.init_state(X, cfg_kf, seed=0, perplexity=hp.perplexity,
                                device=dev)
        step(cfg_kf, st, {(op, "hd"): name})
    del st

    ncfg = nnd.NNDConfig()
    key = threefry.prng_key(0)
    idx, dist = nnd.nnd_init(key, X, ncfg, device=dev)
    for it in range(NND_ITERS):
        if it in (0, NND_ITERS - 1):
            name = "b4_nnd_first" if it == 0 else "b4_nnd_late"

            def rec_nnd(*args, name=name, **kw):
                cases.setdefault(name, ("knn_merge", args, kw))
                return funcsne.KERNELS.knn_merge(*args, **kw)
            ops = funcsne.KERNELS._replace(knn_merge=rec_nnd)
        else:
            ops = funcsne.KERNELS
        idx, dist, _ = nnd.nnd_step(threefry.fold_in(key, it), X, idx, dist,
                                    ncfg, device=dev, ops=ops)

    # the width that stays on the warp route: b2_hd and b4_hd on 783 columns
    x783 = X[:, :783].contiguous()
    for name in WARP_ONLY:
        op, args, kw = cases[name[:-5]]
        cases[name] = (op, (x783,) + args[1:], kw)

    # the same work without the class-sorted locality
    gen = torch.Generator().manual_seed(PERM_SEED)
    perm = torch.randperm(N, generator=gen).to(dev)
    pinv = torch.argsort(perm).to(torch.int32)
    Xp = X[perm]

    def ids(t):
        """Map the ids in [0, N) of ``t`` through the permutation; SENTINEL
        and other out-of-range values stay as they are."""
        ok = (t >= 0) & (t < N)
        return torch.where(ok, pinv[t.long().clamp(0, N - 1)], t)

    def rows(t, order):
        return None if t is None else t[order].contiguous()

    for name in [c for c in cases if c not in WARP_ONLY]:
        op, args, kw = cases[name]
        if op == "knn_merge":
            x, qid, cur_idx, cur_d, cand = args
            cases[name + "_perm"] = (op, (Xp, ids(qid), ids(cur_idx), cur_d,
                                          ids(cand)), kw)
        else:
            x, qid, cur_idx, cur_d = args
            order = torch.randperm(qid.shape[0], generator=gen).to(dev)
            kw_p = dict(kw)
            kw_p["first_tables"] = tuple(rows(t, order)
                                         for t in kw["first_tables"])
            kw_p["extra"] = rows(kw.get("extra"), order)
            kw_p["cur_valid"] = rows(kw.get("cur_valid"), order)
            cases[name + "_perm"] = (op, (x, rows(qid, order),
                                          rows(cur_idx, order),
                                          rows(cur_d, order)), kw_p)

    # the rescore mode at 784 columns: short lists (K, C <= 32) and long
    gen_v = torch.Generator(device=dev).manual_seed(PERM_SEED)
    for name in ("b4_hd", "b4_k128"):
        op, args, kw = cases[name]
        kw_r = dict(kw, cur_valid=torch.rand(args[2].shape, generator=gen_v,
                                             device=dev) < 0.8)
        cases[name + "_rescore"] = (op, args[:3] + (None,) + args[4:], kw_r)

    def stats(op, args, kw):
        """Rows scored and bytes gathered by one call (see the module
        docstring)."""
        x, qid, cur_idx, cur_d = args[:4]
        b, k = cur_idx.shape
        m = x.shape[1]
        if op == "knn_merge":
            cand = args[4]
            valid = knn.dedup_candidates(qid, cur_idx, cand)
            if kw.get("cand_active") is not None:
                valid &= kw["cand_active"]
            lists = cand.numel() * 4
        else:
            cand = knn.counter_candidates(
                kw["salt"], qid, kw["sources"], kw["first_tables"],
                kw["second_tables"], n_total=x.shape[0], extra=kw.get("extra"))
            valid = knn.dedup_candidates(qid, cur_idx, cand)
            if kw.get("active") is not None:
                valid &= kw["active"][cand.long().clamp(0, x.shape[0] - 1)]
            lists = cand.numel() * 4          # the table slots read
        cur_valid = kw.get("cur_valid")
        scored = int(valid.sum()) + (0 if cur_valid is None
                                     else int(cur_valid.sum()))
        lists += qid.numel() * 4 + cur_idx.numel() * 4 * 2   # ids in and out
        lists += cur_idx.numel() * (4 if cur_d is not None else 1)
        lists += cur_idx.numel() * 4 + b                     # new_d, improved
        gathered = scored * m * 4 + b * m * 4 + lists
        return {"B": b, "M": m, "K": k, "C": cand.shape[1], "scored": scored,
                "new_share": float(valid.float().mean()),
                "gathered_bytes": gathered}

    out = {name: (op, args, kw, stats(op, args, kw))
           for name, (op, args, kw) in sorted(cases.items())}
    torch.save(out, path)
    print(json.dumps({k: v[3] for k, v in out.items()}), flush=True)
    return 0


def main() -> int:
    roots, prepared, turns, same = ab_common.run(__file__, __doc__, prepare,
                                                 "merge_wide_ab")
    stats = json.loads(prepared)
    for name, verdict in same.items():
        best = ab_common.best(turns, name)
        routes = {t: next(x["routes"][name] for x in turns if x["tree"] == t)
                  for t in ("old", "new")}
        s = stats[name]
        gb = s["gathered_bytes"] / 1e9
        print(f"{name}: M {s['M']} K {s['K']} C {s['C']}, {s['scored']} rows "
              f"scored ({s['new_share']:.3f} of candidates new), {gb:.4f} GB "
              f"gathered; best ms old {best['old']:.4f} ({gb / best['old']:.3f}"
              f" TB/s), new {best['new']:.4f} ({gb / best['new']:.3f} TB/s), "
              f"{best['new'] / best['old']:.3f}x; routes old {routes['old']}, "
              f"new {routes['new']}; new against old {verdict}", flush=True)
    card = ab_common.card()
    print(card, flush=True)
    print(json.dumps({"roots": roots, "card": card, "stats": stats,
                      "outputs": same, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
