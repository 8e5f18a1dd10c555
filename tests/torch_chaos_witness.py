"""How far ``interactive_hparams``' cluster counts move under rounding, in
each package: the example's five phases at its sizes (1,500 x 48, 300 +
4 x 250 steps) on the CPU, from the JAX ``init_state(PRNGKey(0))`` and from
that state with Y nudged to Y * (1 + 1e-7 z), z ~ N(0, 1) drawn from numpy
seeds 0 .. RUNS - 1; the port's runs start from the same states carried
over by ``convert``.  Each package counts with its own example's
``cluster_count``; each line also gives the first step at which some row's
HD list differs between the packages as a set.

  PYTHONPATH=src python tests/torch_chaos_witness.py [--runs 8]

Not a test (it takes minutes): it says whether a count the card gives
that differs from the JAX example's is within what rounding alone moves.
"""
from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import funcsne as jf
from repro_torch.core import convert
from repro_torch.core import funcsne as tf
from repro_torch.data.synthetic import mnist_like
from repro_torch.examples import interactive_hparams as ih

ROOT = Path(__file__).resolve().parents[1]


def _fields(st):
    out = {k: np.asarray(v) for k, v in st._asdict().items() if k != "rng"}
    out["rng"] = np.asarray(jax.random.key_data(st.rng))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", type=int, default=8)
    runs = ap.parse_args(argv).runs
    spec = importlib.util.spec_from_file_location(
        "ref_interactive_hparams", ROOT / "examples" / "interactive_hparams.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    n, dim = 1500, 48
    X, _ = mnist_like(n=n, dim=dim, seed=0)
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    jcfg = jf.FuncSNEConfig(n_points=n, dim_hd=dim)
    tcfg = tf.FuncSNEConfig(n_points=n, dim_hd=dim)
    tplan = ih.phases(tf.default_hparams(n, perplexity=15.0, device="cpu"))
    hp = jf.default_hparams(n, perplexity=15.0)
    jplan = [hp._replace(exaggeration=jnp.float32(12.0),
                         momentum=jnp.float32(0.5)),
             hp,
             hp._replace(alpha=jnp.float32(0.5), lr=hp.lr * 0.3),
             hp._replace(alpha=jnp.float32(0.5), repulsion=jnp.float32(3.0),
                         lr=hp.lr * 0.3),
             hp._replace(perplexity=jnp.float32(40.0), lr=hp.lr * 0.3)]
    jstep, tstep = jf.make_step(jcfg), tf.make_step(tcfg)
    for seed in [None] + list(range(runs)):
        # a state of its own each run: the step donates its input's buffers
        st = jf.init_state(jax.random.PRNGKey(0), Xj, jcfg)
        if seed is not None:
            z = np.random.default_rng(seed).standard_normal(
                st.Y.shape).astype(np.float32)
            st = st._replace(Y=st.Y * (1 + 1e-7 * jnp.asarray(z)))
        tst = convert.state_from_numpy(_fields(st), tcfg, "cpu")
        jcounts, tcounts, t, parted = [], [], 0, None
        for ph, (_, iters, tph) in zip(jplan, tplan):
            for _ in range(iters):
                st = jstep(st, Xj, ph)
                tst = tstep(tst, Xt, tph)
                t += 1
                if parted is None and not np.array_equal(
                        np.sort(np.asarray(st.hd_idx), 1),
                        np.sort(tst.hd_idx.numpy(), 1)):
                    parted = t
            jcounts.append(ref.cluster_count(np.asarray(st.Y)))
            tcounts.append(ih.cluster_count(tst.Y))
        label = "unnudged" if seed is None else f"nudge seed {seed}"
        print(f"{label:14s} JAX {jcounts}  port {tcounts}  (first HD list "
              f"that differs as a set: step {parted})", flush=True)


if __name__ == "__main__":
    main()
