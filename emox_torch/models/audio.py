"""wav2vec2-compatible audio encoder + audio->video-frame alignment
(counterpart of emox/models/audio.py).

Conv front-end with a per-channel group norm on layer 0 only, post-LN
transformer, grouped positional conv. Framing: per-video-frame windows of
2*context+1 feature vectors, zero outside the clip.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.core.config import AudioConfig
from emox_torch.nn.attention_blocks import Attention
from emox_torch.nn.layers import AffineNorm, Conv, Dense, LayerNorm


class GroupNorm(AffineNorm):
    """flax.linen.GroupNorm over [B, L, C]: fp32 statistics over (L, C/groups)
    with the fast variance clipped at 0, affine in fp32, one rounding."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5):
        super().__init__(channels, eps)
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        xg = x.float().reshape(b, l, self.groups, c // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg.square().mean(dim=(1, 3), keepdim=True) - mean.square()).clamp_min(0.0)
        scale = self.weight.float().reshape(self.groups, -1)
        y = (xg - mean) * (torch.rsqrt(var + self.eps) * scale)
        return (y.reshape(b, l, c) + self.bias.float()).to(x.dtype)


class ConvFeatureExtractor(nn.Module):
    """Raw waveform [B, S] -> [B, T_a, conv_dim] (wav2vec2 conv stack: group
    norm after layer 0 only, no biases, GELU)."""

    def __init__(self, cfg: AudioConfig):
        super().__init__()
        self.num_convs = len(cfg.conv_kernels)
        ch = 1
        for i, (k, s) in enumerate(zip(cfg.conv_kernels, cfg.conv_strides)):
            setattr(self, f"conv{i}", Conv(ch, cfg.conv_dim, (k,), stride=s, padding="VALID", bias=False))
            ch = cfg.conv_dim
        self.gn0 = GroupNorm(cfg.conv_dim, groups=cfg.conv_dim)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        h = wav[..., None]
        for i in range(self.num_convs):
            h = getattr(self, f"conv{i}")(h)
            if i == 0:
                h = self.gn0(h)
            h = F.gelu(h)
        return h


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (wav2vec2-base)."""

    def __init__(self, cfg: AudioConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.attn = Attention(d, cfg.num_heads, d // cfg.num_heads, qkv_bias=True)
        self.norm1 = LayerNorm(d)
        self.ff1 = Dense(d, 4 * d)
        self.ff2 = Dense(4 * d, d)
        self.norm2 = LayerNorm(d)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.norm1(h + self.attn(h))
        return self.norm2(h + self.ff2(F.gelu(self.ff1(h))))


class AudioEncoder(nn.Module):
    """waveform [B, S] -> features [B, T_a, hidden_dim] at 50 Hz."""

    def __init__(self, cfg: AudioConfig):
        super().__init__()
        self.num_layers = cfg.num_layers
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.feat_norm = LayerNorm(cfg.conv_dim)
        self.feat_proj = Dense(cfg.conv_dim, cfg.hidden_dim)
        # grouped positional conv, kernel 128 pad 64, last step dropped
        self.pos_conv = Conv(cfg.hidden_dim, cfg.hidden_dim, (128,), padding=((64, 64),), groups=16)
        self.enc_norm = LayerNorm(cfg.hidden_dim)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", EncoderLayer(cfg))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        h = self.feat_proj(self.feat_norm(self.feature_extractor(wav)))
        h = h + F.gelu(self.pos_conv(h)[:, :-1])
        h = self.enc_norm(h)
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h)
        return h


def align_audio_to_frames(features: torch.Tensor, num_frames: int, feature_rate: float,
                          video_fps: float = 25.0, context: int = 2,
                          frame_offset: float = 0.0) -> torch.Tensor:
    """Per-video-frame audio windows [B, T, 2*context+1, D]: frame f's window
    holds the features nearest to the timestamps of frames f-context ..
    f+context (round half to even), zero outside the clip."""
    b, ta, d = features.shape
    dev = features.device
    frame_idx = torch.arange(num_frames, dtype=torch.float32, device=dev) + frame_offset
    offsets = torch.arange(-context, context + 1, dtype=torch.float32, device=dev)
    pos = (frame_idx[:, None] + offsets[None, :]) / video_fps * feature_rate
    idx = torch.round(pos).to(torch.int64)  # [T, A]
    valid = (idx >= 0) & (idx < ta)
    gathered = features[:, idx.clamp(0, ta - 1).reshape(-1), :].reshape(b, num_frames, offsets.shape[0], d)
    return torch.where(valid[None, :, :, None], gathered, torch.zeros((), dtype=features.dtype, device=dev))


def audio_feature_rate(cfg: AudioConfig) -> float:
    return cfg.sample_rate / cfg.total_stride
