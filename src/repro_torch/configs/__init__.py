"""Architecture configs: the 10 architectures + reduced smoke variants."""

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeSpec, SHAPES, get_arch, list_archs, smoke_variant)
