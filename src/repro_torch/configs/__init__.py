from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, applicable_shapes
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "applicable_shapes",
           "ARCH_IDS", "get_config", "smoke_config"]
