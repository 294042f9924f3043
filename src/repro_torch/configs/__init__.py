"""Per-architecture configs of the port (one module per dense arch the
port builds) and their base types."""

from .base import SHAPES, ModelConfig, ShapeConfig

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig"]
