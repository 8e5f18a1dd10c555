"""Learning-rate schedules (port of ``repro.optim.schedules``): count ->
lr, for a 0-d integer tensor ``count`` (the 1-indexed step count), as a
0-d float32 tensor on its device."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda count: torch.tensor(lr, dtype=torch.float32,
                                      device=count.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(count):
        c = count.float()
        warm = peak_lr * c / max(warmup_steps, 1)
        t = torch.clamp((c - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(c < warmup_steps, warm, cos)
    return fn


def linear_decay(peak_lr: float, total_steps: int):
    def fn(count):
        t = torch.clamp(count.float() / total_steps, 0.0, 1.0)
        return peak_lr * (1.0 - t)
    return fn
