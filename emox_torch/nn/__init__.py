"""nn: layers, embeddings, resnet blocks, conditioners, transformer blocks."""

from emox_torch.nn.attention_blocks import (
    Attention,
    AudioCrossAttention,
    FrameAxisAttention,
    GEGLUFeedForward,
    SpatialTransformer,
    TemporalTransformer,
    TransformerBlock,
)
from emox_torch.nn.blocks import Downsample, FusedGroupNorm, ResBlock, Upsample, fold_time, unfold_time
from emox_torch.nn.conditioners import FaceMaskEncoder, SpeedEncoder
from emox_torch.nn.embeddings import TimestepEmbedder, sinusoidal_positions, timestep_embedding
from emox_torch.nn.layers import Conv, Dense, LayerNorm, init_weights

__all__ = [
    "Attention",
    "AudioCrossAttention",
    "Conv",
    "Dense",
    "Downsample",
    "FaceMaskEncoder",
    "FrameAxisAttention",
    "FusedGroupNorm",
    "GEGLUFeedForward",
    "LayerNorm",
    "ResBlock",
    "SpatialTransformer",
    "SpeedEncoder",
    "TemporalTransformer",
    "TimestepEmbedder",
    "TransformerBlock",
    "Upsample",
    "fold_time",
    "init_weights",
    "sinusoidal_positions",
    "timestep_embedding",
    "unfold_time",
]
