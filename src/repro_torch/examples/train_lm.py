"""End-to-end driver: train a ~100M-class LM for a few hundred steps with
checkpoint/restart (the counterpart of ``examples/train_lm.py``, a thin
wrapper over ``repro_torch.launch.train``).

  python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

Reduced qwen2-7b (d 256, 4 layers, 8 / 4 heads of 32, vocab 8,192,
float32), B 8 x 256 tokens, checkpoints every 50 steps under
``checkpoints/example_train`` in the working directory; further arguments
override these (``--ckpt-dir``, ``--fail-at``, ...).
"""
from __future__ import annotations

import sys

from repro_torch.launch import train

ARGS = ["--arch", "qwen2-7b", "--reduce", "--steps", "300", "--batch", "8",
        "--seq", "256", "--ckpt-dir", "checkpoints/example_train"]


def main(argv=None):
    """Returns the trainer's history."""
    return train.main(ARGS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
