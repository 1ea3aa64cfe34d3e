"""EMO conditioning modules (counterpart of emox/nn/conditioners.py).

  * SpeedEncoder: head-rotation speeds -> tanh bucket encodings -> MLP,
    added to the denoiser's time embedding.
  * FaceMaskEncoder: face mask -> latent-resolution residual added at the
    denoiser's conv_in (zero-init final conv).
  * FaceLocator: RGB frame -> face-region logit mask at the frame's size.
  * FaceLandmarkNet: RGB frame -> 6 facial landmarks by heatmap soft-argmax.

The two face nets (stage 0 trains them; emox/assets/face_nets.npz holds
trained weights, `emox_torch.train.face_nets.load_face_nets`) share one
trunk: three 3x3 SAME convs, each followed by ReLU and a 2x2 max-pool of
stride 2.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.nn.layers import Conv, Dense, resize_bilinear


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


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """flax nn.max_pool(x, (2, 2), strides=(2, 2)) on [B, H, W, C] (VALID)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class _FaceTrunk(nn.Module):
    """conv{i} (3x3, SAME) -> ReLU -> 2x2 max-pool, for each width in
    `features`: [B, H, W, 3] -> [B, H/2^n, W/2^n, features[-1]]."""

    def __init__(self, features: Sequence[int], in_channels: int = 3):
        super().__init__()
        self.depth = len(features)
        ch = in_channels
        for i, f in enumerate(features):
            setattr(self, f"conv{i}", Conv(ch, f, (3, 3)))
            ch = f

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.depth):
            h = _max_pool_2x2(F.relu(getattr(self, f"conv{i}")(h)))
        return h


class FaceLocator(_FaceTrunk):
    """RGB frame [B, H, W, 3] -> face-region logit mask [B, H, W, 1]: a 1x1
    conv head on the trunk, upsampled as jax.image.resize's "bilinear"."""

    def __init__(self, features: Sequence[int] = (32, 64, 128)):
        super().__init__(features)
        self.head = Conv(features[-1], 1, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.head(self.trunk(x))
        return resize_bilinear(logits, x.shape[1], x.shape[2])


class FaceLandmarkNet(_FaceTrunk):
    """RGB frame [B, H, W, 3] -> 6 landmarks [B, 6, 2], normalised (y, x) in
    [0, 1] (nose tip, chin, left and right eye outer corners, left and right
    mouth corners): a 1x1 conv to one heatmap a point, then an fp32 softmax
    over the map's cells and the expected cell centre (i + 0.5) / n."""

    def __init__(self, num_points: int = 6, features: Sequence[int] = (32, 64, 128)):
        super().__init__(features)
        self.heat = Conv(features[-1], num_points, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        heat = self.heat(self.trunk(x))  # [B, h, w, P]
        b, hh, ww, p = heat.shape
        w = torch.softmax(heat.reshape(b, hh * ww, p).float(), dim=1)
        ys = (torch.arange(hh, dtype=torch.float32, device=x.device) + 0.5) / hh
        xs = (torch.arange(ww, dtype=torch.float32, device=x.device) + 0.5) / ww
        y = torch.einsum("blp,l->bp", w, ys.repeat_interleave(ww))
        x_ = torch.einsum("blp,l->bp", w, xs.repeat(hh))
        return torch.stack([y, x_], dim=-1).to(heat.dtype)
