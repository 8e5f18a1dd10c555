"""Offline fsck of a checkpoint directory (port of
``repro.checkpoint.verify``).

    python -m repro_torch.checkpoint.verify <dir> [--step N]

Runs the verification of ``Checkpointer.restore`` (CRC32 per file, the
array manifest, row coverage, the n_hosts count) over every committed step
-- or one ``--step`` -- printing one line per step, and exits 1 when any
step is damaged.  Nothing is loaded into a tree, so it is safe to run
against the checkpoint directory of a live run.  Its lines and exit codes
are the JAX package's.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.checkpoint.checkpointer import (CheckpointCorrupt,
                                                 Checkpointer)


def verify_dir(directory, step=None, out=None) -> int:
    """Verify every committed step (or just ``step``); returns the number
    of damaged steps.  Prints ``step N: OK ...`` / ``step N: CORRUPT ...``
    one line per step to ``out`` (default stdout)."""
    out = sys.stdout if out is None else out
    ck = Checkpointer(directory, keep_last=0)    # never saves: no pruning
    steps = ck.all_steps()
    if step is not None:
        steps = [s for s in steps if s == step]
        if not steps:
            print(f"step {step}: NOT FOUND "
                  f"(available: {ck.all_steps() or '(none)'})", file=out)
            return 1
    if not steps:
        print(f"no committed checkpoints under {directory}", file=out)
        return 0
    bad = 0
    for s in steps:
        try:
            meta = ck.verify_step(s)
        except CheckpointCorrupt as e:
            bad += 1
            print(f"step {s}: CORRUPT -- {e.reason}", file=out)
            continue
        man = meta.get("manifest", {})
        print(f"step {s}: OK ({len(man.get('files', {}))} shard file(s), "
              f"n_hosts={man.get('n_hosts')})", file=out)
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.checkpoint.verify",
        description="offline integrity check of a checkpoint directory")
    ap.add_argument("dir", help="checkpoint directory (holds step_* dirs)")
    ap.add_argument("--step", type=int, default=None,
                    help="verify only this step (default: all)")
    args = ap.parse_args(argv)
    bad = verify_dir(args.dir, step=args.step)
    if bad:
        print(f"{bad} damaged step(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
