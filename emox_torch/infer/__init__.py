"""Inference: the serving pipeline, video IO and the exported denoise step
(emox_torch.infer.export)."""

from emox_torch.infer.pipeline import EMOPipeline

__all__ = ["EMOPipeline"]
