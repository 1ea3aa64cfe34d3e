"""Inference: the serving pipeline and video IO."""

from emox_torch.infer.pipeline import EMOPipeline

__all__ = ["EMOPipeline"]
