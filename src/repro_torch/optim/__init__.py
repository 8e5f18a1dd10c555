"""Optimisers, schedules, int8 moments and gradient compression (port of
``repro.optim``)."""
from repro_torch.optim.optimizers import adamw, sgdm, clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedules import warmup_cosine, constant  # noqa: F401
