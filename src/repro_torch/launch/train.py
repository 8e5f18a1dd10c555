"""End-to-end LM training launcher on one device (port of
``repro.launch.train``).

Example (a ~160M qwen2-style model for a few hundred steps):
  python -m repro_torch.launch.train --arch qwen2-7b --reduce \\
      --steps 300 --batch 8 --seq 512

``--reduce`` shrinks the arch to a small trainable size while keeping its
family topology; without it the full assigned config is built.
Checkpoint/restart: re-running the same command resumes from the last
committed checkpoint (see --fail-at for the injection test).  ``--device``
is ``cuda`` by default and raises without a card; ``--device cpu`` runs the
plain versions of the kernels.  Parameters come from ``init_params(0)``
(the JAX ``PRNGKey(0)``'s draws, by threefry); ``embeds``-mode inputs from
``threefry.normal(fold_in(prng_key(7), step), ...)`` as the JAX launcher's
``jax.random`` draws.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.base import get_arch, smoke_variant
from repro_torch.core import threefry
from repro_torch.core.funcsne import resolve_device
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.launch.steps import (make_model, make_optimizer,
                                      make_train_step)
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def reduced_variant(cfg, d_model=256, n_layers=4):
    base = smoke_variant(cfg)
    return dataclasses.replace(
        base, name=cfg.name + "-reduced", d_model=d_model,
        n_layers=max(n_layers, 2 if base.shared_attn_every == 0 else 4),
        n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4) or 4, head_dim=32,
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 8192))


def make_data_fn(cfg, batch: int, seq: int, device):
    """step -> {"inputs", "labels"} on ``device``: the token stream's pair,
    or for ``embeds`` mode threefry normals as inputs."""
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))

    def data_fn(step):
        x, y = stream.train_pair(step)
        labels = torch.from_numpy(y).to(device)
        if cfg.input_mode == "embeds":
            emb = threefry.normal(
                threefry.fold_in(threefry.prng_key(7), step),
                (batch, seq, cfg.d_model), device=device)
            return {"inputs": emb, "labels": labels}
        return {"inputs": torch.from_numpy(x).to(device), "labels": labels}

    return data_fn


def main(argv=None):
    """Run the CLI; returns the trainer's history (one dict a step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduce:
        cfg = reduced_variant(cfg)
    model = make_model(cfg)
    opt = make_optimizer(cfg, peak_lr=args.lr, warmup=50, total=args.steps)
    step_fn = make_train_step(model, opt)
    data_fn = make_data_fn(cfg, args.batch, args.seq, dev)

    params = model.init_params(0, device=dev)
    opt_state = opt.init(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} device={dev}")

    trainer = Trainer(TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir, fail_at_step=args.fail_at),
        step_fn, data_fn, params, opt_state)
    trainer.maybe_restore()
    history = trainer.run()
    print(f"[train] done: first loss {history[0]['loss']:.4f} "
          f"last loss {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
