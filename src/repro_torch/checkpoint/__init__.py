"""Checkpoints of the port in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpointer import (CheckpointCorrupt,  # noqa: F401
                                                 CheckpointError,
                                                 CheckpointIncompatible,
                                                 CheckpointNotFound,
                                                 Checkpointer, cfg_compat,
                                                 row_shard_filter)
