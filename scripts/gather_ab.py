#!/usr/bin/env python3
"""B1 (gathered squared distances) of two checkouts of this repository, on
the same inputs, timed in turns on one CUDA card.

  python3 scripts/gather_ab.py OLD_ROOT NEW_ROOT [--rounds 1]

One process, importing OLD_ROOT's ``repro_torch``, makes the inputs once
and saves them under ``NEW_ROOT/build/``.  At MNIST's shape
(``synthetic.mnist_like(n=70000, dim=784, seed=0)``, rows sorted by class,
the default config) it records the B1 call of every place that runs one:

  init_hd        init_state's HD lists: 784 columns, C 32 (init_knn_idx)
  init_ld        init_state's LD lists: Y at d 2, C 16
  unfused_hd     merge_fused=False, HD candidates behind the gate: 784,
                 C 10, from the main path's state after STEPS steps
  unfused_ld     the same step's LD lists and candidates: d 2, K + C = 24
  nnd_init       nnd_init's random lists: 784, C 32
  latents_hd     the latents fit's init_state: 16 columns, C 32
  latents_ld     its LD lists: d 8, C 16
  c1_ld_d5/8/32  merge_fused=False's LD call at dim_ld 5, 8, 32: 24 slots
  odd_m783       init_hd on the first 783 columns of X (M % 4 != 0)
  misaligned     unfused_hd on a copy of X that starts 4 bytes past 16

The latents fit runs on the PCA-16 projection of pooled frames of
``embed_latents.make_frames`` (N_LAT sequences; the model's forward is
left out: B1 does the same work whatever the values).  Each turn is then a
process of its own that imports one checkout's ``repro_torch`` (its
kernels built from that checkout's sources into its own ``build/``), runs
every case once, saves the outputs and times each case from CUDA graphs
(``ab_common``: ``REPEATS`` replays of a graph of ``REPS`` calls).  A
round runs old, new, new, old.  Prints, for each case, its shape, the rows
it scores (B x C: B1 scores every slot), the bytes it gathers ((1 + C)
rows of M floats a query, the ids and the output), the effective rate
(those bytes over the best time), its bound (the larger of x, the ids and
the output moved once over 3.35 TB/s and 3 B C M operations over 67
TFLOP/s), the best time of each tree, the routes each launched, and
whether the outputs are bit for bit the old tree's (int32 views); the
card's name and power limit; and one JSON line with all of it.  Unpack the
older commit with ``git archive`` into a directory that ``.gitignore``
lists, e.g. ``build/parent``; with both roots the parent it measures the
spread.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import ab_common

N, DIM, STEPS, CHUNK = 70_000, 784, 500, 50
N_LAT, LAT_FRAME = 4_096, 256
WIDTHS = (5, 8, 32)            # chip_smoke's phase (j) beside the main 2
HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12


def prepare(root: str, path: str) -> int:
    """Make the inputs with ``root``'s kernels; save {case: (op, args, kw,
    stats)}."""
    ab_common.import_root(root)
    import torch
    from repro_torch.core import funcsne, nnd, threefry
    from repro_torch.data import synthetic
    from repro_torch.examples import embed_latents
    dev = torch.device("cuda")
    X = torch.from_numpy(synthetic.mnist_like(n=N, dim=DIM, seed=0)[0]).to(dev)
    cfg = funcsne.FuncSNEConfig(n_points=N, dim_hd=DIM)
    hp = funcsne.default_hparams(N, device=dev)
    cases = {}

    def recording(names):
        """The kernels, with B1's first call on rows of each width in
        ``names`` ({M: case}) recorded."""
        def b1(x, qid, cand):
            if x.shape[1] in names:
                cases.setdefault(names[x.shape[1]],
                                 ("pairwise_sqdist_gather", (x, qid, cand),
                                  {}))
            return funcsne.KERNELS.pairwise_sqdist_gather(x, qid, cand)
        return funcsne.KERNELS._replace(pairwise_sqdist_gather=b1)

    def forced(s):              # E[N_new/N] = 1: the refinement gate fires
        return s._replace(ema_new_frac=torch.ones_like(s.ema_new_frac))

    st = funcsne.init_state(X, cfg, seed=0, perplexity=hp.perplexity,
                            device=dev,
                            ops=recording({DIM: "init_hd", 2: "init_ld"}))
    chunk = funcsne.make_chunked_step(cfg, CHUNK,
                                      schedule=funcsne.default_schedule,
                                      n_iter=STEPS)
    for _ in range(STEPS // CHUNK):
        st, _, _ = chunk(st, X, hp)
    funcsne.funcsne_step(dataclasses.replace(cfg, merge_fused=False),
                         forced(st), X, hp,
                         ops=recording({DIM: "unfused_hd", 2: "unfused_ld"}))
    del st
    nnd.nnd_init(threefry.prng_key(0), X, nnd.NNDConfig(), device=dev,
                 ops=recording({DIM: "nnd_init"}))

    frames, _ = embed_latents.make_frames(N_LAT, LAT_FRAME)
    Hp = embed_latents.project(torch.from_numpy(frames.mean(axis=1)).to(dev))
    del frames
    cfg_ne, hp_ne = embed_latents.ne_config(N_LAT, dev)
    funcsne.init_state(Hp, cfg_ne, seed=0, perplexity=hp_ne.perplexity,
                       device=dev, ops=recording({cfg_ne.dim_hd: "latents_hd",
                                                  cfg_ne.dim_ld: "latents_ld"}))
    for d in WIDTHS:
        cfg_w = dataclasses.replace(cfg, dim_ld=d, merge_fused=False)
        st = funcsne.init_state(X, cfg_w, seed=0, perplexity=hp.perplexity,
                                device=dev)
        funcsne.funcsne_step(cfg_w, forced(st), X, hp,
                             ops=recording({d: f"c1_ld_d{d}"}))
        del st

    _, (_, qid, cand), _ = cases["init_hd"]
    cases["odd_m783"] = ("pairwise_sqdist_gather",
                         (X[:, :783].contiguous(), qid, cand), {})
    shifted = torch.empty(N * DIM + 1, device=dev)[1:].view(N, DIM)
    shifted.copy_(X)
    assert shifted.data_ptr() % 16 == 4
    _, (_, qid, cand), _ = cases["unfused_hd"]
    cases["misaligned"] = ("pairwise_sqdist_gather", (shifted, qid, cand), {})

    def stats(x, qid, cand):
        """Rows scored, bytes gathered and the bound of one call (see the
        module docstring)."""
        b, c = cand.shape
        m = x.shape[1]
        ids_out = 4 * (b + 2 * b * c)
        once = x.numel() * 4 + ids_out
        bound = max(once / HBM_BYTES_PER_S, 3.0 * b * c * m / FP32_FLOPS_PER_S)
        return {"N": x.shape[0], "B": b, "M": m, "C": c, "scored": b * c,
                "gathered_bytes": b * (1 + c) * m * 4 + ids_out,
                "bound_ms": bound * 1e3,
                "bound_by": ("bytes" if once / HBM_BYTES_PER_S
                             >= 3.0 * b * c * m / FP32_FLOPS_PER_S
                             else "operations"),
                "aligned": x.data_ptr() % 16 == 0}

    out = {name: (op, args, kw, stats(*args))
           for name, (op, args, kw) in sorted(cases.items())}
    torch.save(out, path)
    print(json.dumps({k: v[3] for k, v in out.items()}), flush=True)
    return 0


def main() -> int:
    roots, prepared, turns, same = ab_common.run(__file__, __doc__, prepare,
                                                 "gather_ab")
    stats = json.loads(prepared)
    for name, verdict in same.items():
        best = ab_common.best(turns, name)
        routes = {t: next(x["routes"][name] for x in turns if x["tree"] == t)
                  for t in ("old", "new")}
        s = stats[name]
        gb = s["gathered_bytes"] / 1e9
        print(f"{name}: B {s['B']} M {s['M']} C {s['C']}"
              + ("" if s["aligned"] else " (x not on 16 bytes)")
              + f", {s['scored']} rows scored, {gb:.4f} GB gathered; bound "
              f"{s['bound_ms']:.4f} ms by {s['bound_by']}; best ms old "
              f"{best['old']:.4f} ({gb / best['old']:.3f} TB/s), new "
              f"{best['new']:.4f} ({gb / best['new']:.3f} TB/s), "
              f"{best['new'] / best['old']:.3f}x; routes old {routes['old']}, "
              f"new {routes['new']}; new against old {verdict}", flush=True)
    card = ab_common.card()
    print(card, flush=True)
    print(json.dumps({"roots": roots, "card": card, "stats": stats,
                      "outputs": same, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
