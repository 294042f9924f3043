"""Per-architecture configs of the port (one module per arch the port
builds: dense, moe, ssm and hybrid) and their base types."""

from .base import SHAPES, ModelConfig, ShapeConfig

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig"]
