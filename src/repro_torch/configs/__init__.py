from .base import (
    LONG_CONTEXT_OK, SHAPES, ModelConfig, MoESpec, SSMSpec, ShapeSpec,
    param_counts, shape_applicable,
)
from .registry import ARCHS, get_arch

__all__ = [
    "ARCHS", "get_arch", "ModelConfig", "MoESpec", "SSMSpec", "ShapeSpec",
    "SHAPES", "LONG_CONTEXT_OK", "param_counts", "shape_applicable",
]
