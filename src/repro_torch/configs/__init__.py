from .base import SHAPES, ModelConfig, ShapeConfig
from .registry import ARCHS, cells, get_config, list_archs, smoke_config

__all__ = [
    "SHAPES", "ModelConfig", "ShapeConfig",
    "ARCHS", "cells", "get_config", "list_archs", "smoke_config",
]
