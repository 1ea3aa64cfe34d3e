"""EMO conditioning modules (counterpart of emox/nn/conditioners.py).

  * SpeedEncoder: head-rotation speeds -> tanh bucket encodings -> MLP,
    added to the denoiser's time embedding.
  * FaceMaskEncoder: face mask -> latent-resolution residual added at the
    denoiser's conv_in (zero-init final conv).

FaceLocator and FaceLandmarkNet wait for a later slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.nn.layers import Conv, Dense


class SpeedEncoder(nn.Module):
    """[B, S] head-rotation speeds (S axes) -> [B, dim]."""

    def __init__(self, dim: int, axes: int = 1, num_buckets: int = 9, bucket_radius: float = 0.1,
                 max_speed: float = 1.0):
        super().__init__()
        self.num_buckets = num_buckets
        self.bucket_radius = bucket_radius
        self.max_speed = max_speed
        self.fc1 = Dense(axes * num_buckets, dim)
        self.fc2 = Dense(dim, dim, zero_init=True)

    def bucket_centers(self, device=None) -> torch.Tensor:
        return torch.linspace(-self.max_speed, self.max_speed, self.num_buckets, device=device)

    def encode_speed(self, speed: torch.Tensor) -> torch.Tensor:
        """Soft bucket encoding: tanh((s - c_i) / r) per bucket."""
        centers = self.bucket_centers(speed.device)
        return torch.tanh((speed[..., None] - centers) / self.bucket_radius)

    def forward(self, speeds: torch.Tensor) -> torch.Tensor:
        if speeds.dim() == 1:
            speeds = speeds[:, None]
        enc = self.encode_speed(speeds.float()).reshape(speeds.shape[0], -1)
        return self.fc2(F.silu(self.fc1(enc)))


class FaceMaskEncoder(nn.Module):
    """Face mask [B, H, W, 1] -> [B, H/2^num_downs, W/2^num_downs, out_channels]."""

    def __init__(self, out_channels: int, num_downs: int = 3, features: Sequence[int] = (16, 32, 96),
                 in_channels: int = 1):
        super().__init__()
        self.num_downs = num_downs
        ch = in_channels
        for i in range(num_downs):
            f = features[min(i, len(features) - 1)]
            setattr(self, f"conv{i}", Conv(ch, f, (3, 3), stride=2))
            ch = f
        self.zero_conv = Conv(ch, out_channels, (3, 3), zero_init=True)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        h = mask
        for i in range(self.num_downs):
            h = F.silu(getattr(self, f"conv{i}")(h))
        return self.zero_conv(h)
