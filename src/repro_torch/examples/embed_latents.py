"""Paper Sec. 4.2 (ImageNet/EVA pipeline shape) on the port: embed the
hidden states of an LM backbone with a higher-dimensional FUnc-SNE and
evaluate 1-NN transfer -- model latents -> PCA -> 8-D NE -> 1-NN.

The counterpart of ``examples/embed_latents.py`` step for step: the same
numpy data (8 prototypes x 2, noise 0.7, ``default_rng(0)``), mean-pooled
``hidden_states`` in batches of 64, ``pca_directions(., 16)``, ``fit`` with
dim_hd 16, dim_ld 8, 500 steps at perplexity 12, and one-shot 1-NN over 5
trials for the latents, pca16 and funcsne8.  The backbone's weights come
from ``init_params(0)`` (threefry: the JAX package's ``PRNGKey(0)``
weights).  On the card every layer's attention is B8.

  python -m repro_torch.examples.embed_latents [--device cpu] \\
      [--arch musicgen-large] [--smoke] [--n-seq N]

``--smoke`` runs the config's ``smoke_variant`` (the JAX example's
backbone); without it the architecture runs at its full width and depth.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch, smoke_variant
from repro_torch.core import funcsne, threefry
from repro_torch.core.quality import one_nn_accuracy
from repro_torch.models.transformer import LMModel

SEQ, BATCH, N_CLASSES = 24, 64, 8


def make_frames(n_seq: int, d_model: int, seq: int = SEQ):
    """Synthetic "audio": 8 latent classes of frame-embedding sequences
    ((n_seq, seq, d_model) float32 frames and (n_seq,) labels)."""
    rng = np.random.default_rng(0)
    protos = rng.normal(size=(N_CLASSES, d_model)).astype(np.float32) * 2.0
    labels = rng.integers(0, N_CLASSES, n_seq)
    frames = (protos[labels][:, None, :]
              + rng.normal(size=(n_seq, seq, d_model))
              .astype(np.float32) * 0.7)
    return frames, labels


def latents(model: LMModel, params, frames, device, batch: int = BATCH):
    """Mean-pooled final hidden states, (n_seq, d_model) float32 on
    ``device``."""
    out = []
    for i in range(0, frames.shape[0], batch):
        x = torch.from_numpy(frames[i:i + batch]).to(device)
        out.append(model.hidden_states(params, x).mean(dim=1).float())
    return torch.cat(out)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def project(H):
    """The latents' projection on their first 16 principal directions."""
    return (H - H.mean(dim=0)) @ funcsne.pca_directions(H, 16)


def ne_config(n_seq: int, device):
    """The 8-D FUnc-SNE of the pipeline: (config, hparams)."""
    return (funcsne.FuncSNEConfig(n_points=n_seq, dim_hd=16, dim_ld=8),
            funcsne.default_hparams(n_seq, perplexity=12.0, device=device))


def embed_and_score(H, labels, device, n_iter: int = 500):
    """PCA(16) -> FUnc-SNE(8) -> one-shot 1-NN.  Returns (accuracies
    {name: float}, the fit's final state, the fit's wall seconds)."""
    Hp = project(H)
    cfg_ne, hp = ne_config(H.shape[0], device)
    _sync(device)
    t0 = time.perf_counter()
    st, _ = funcsne.fit(Hp, cfg=cfg_ne, n_iter=n_iter, hparams=hp,
                        device=device)
    _sync(device)
    fit_s = time.perf_counter() - t0
    lab = torch.from_numpy(np.asarray(labels)).to(device)
    acc = {name: float(one_nn_accuracy(Z, lab, threefry.prng_key(1),
                                       n_trials=5, one_shot=True))
           for name, Z in (("backbone latents", H), ("pca16", Hp),
                           ("funcsne8", st.Y))}
    return acc, st, fit_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's smoke_variant")
    ap.add_argument("--n-seq", type=int, default=512)
    args = ap.parse_args(argv)
    dev = funcsne.resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    model = LMModel(cfg)
    params = model.init_params(0, device=dev)
    frames, labels = make_frames(args.n_seq, cfg.d_model)
    H = latents(model, params, frames, dev)
    acc, _, _ = embed_and_score(H, labels, dev)
    for name, a in acc.items():
        print(f"one-shot 1-NN accuracy on {name:18s}: {a:.3f}")
    return acc


if __name__ == "__main__":
    main()
