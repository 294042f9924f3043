"""Per-architecture configs of the port (one module per arch of the
reference: dense, moe, ssm, hybrid, audio and vlm) and their base types."""

from .base import SHAPES, ModelConfig, ShapeConfig

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig"]
