"""Training data of the port: the counter-based synthetic pipeline."""

from .pipeline import PipelineState, SyntheticPipeline

__all__ = ["PipelineState", "SyntheticPipeline"]
