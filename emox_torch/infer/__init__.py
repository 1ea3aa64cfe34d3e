"""Inference: the serving pipeline."""

from emox_torch.infer.pipeline import EMOPipeline

__all__ = ["EMOPipeline"]
