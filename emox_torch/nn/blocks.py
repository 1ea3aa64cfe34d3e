"""Conv/resnet building blocks, NHWC pseudo-3D (counterpart of emox/nn/blocks.py).

Video tensors are [B, T, H, W, C]; spatial convs run over the folded
[(B T), H, W, C].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.nn.layers import AffineNorm, Conv, Dense
from emox_torch.ops.groupnorm import group_norm


def fold_time(x: torch.Tensor):
    """[B, T, H, W, C] -> [(B T), H, W, C]; returns (folded, T). 4D passes through."""
    if x.dim() == 4:
        return x, 1
    b, t, h, w, c = x.shape
    return x.reshape(b * t, h, w, c), t


def unfold_time(x: torch.Tensor, t: int) -> torch.Tensor:
    """[(B T), H, W, C] -> [B, T, H, W, C] (always 5D, even for t=1)."""
    bt, h, w, c = x.shape
    return x.reshape(bt // t, t, h, w, c)


class FusedGroupNorm(AffineNorm):
    """GroupNorm(+SiLU) over NHWC feature maps through emox_torch.ops.group_norm
    (plain by default; EMOX_GROUPNORM_IMPL=pallas|fast takes the kernels)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5, silu: bool = False):
        super().__init__(channels, eps)
        self.groups = groups
        self.silu = silu

    def forward(self, x: torch.Tensor, silu: Optional[bool] = None) -> torch.Tensor:
        c = x.shape[-1]
        shape = x.shape
        xl = x.reshape(-1, shape[-3] * shape[-2], c) if x.dim() >= 3 else x
        silu = self.silu if silu is None else silu
        return group_norm(xl, self.weight, self.bias, self.groups, self.eps, silu=silu).reshape(shape)


class ResBlock(nn.Module):
    """GN+SiLU -> conv3x3 -> (+time scale-shift) -> GN+SiLU -> conv3x3 + skip.

    temb_dim=None builds the block without a time projection (the VAE's).
    separable=True makes each 3x3 conv `{name}_dw`, a depthwise 3x3 (one
    filter a channel, with bias), followed by `{name}_pw`, a 1x1 to the
    output width: the reference's flax names and its plain convolutions."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 temb_dim: Optional[int] = None, temb_mode: str = "scale_shift",
                 separable: bool = False):
        super().__init__()
        if temb_mode not in ("scale_shift", "add"):
            raise ValueError(f"unknown temb_mode {temb_mode!r}")
        self.temb_mode = temb_mode
        self.separable = separable
        self.norm1 = FusedGroupNorm(in_channels, groups, silu=True)
        self._add_conv3x3("conv1", in_channels, out_channels)
        if temb_dim is not None:
            n_out = 2 * out_channels if temb_mode == "scale_shift" else out_channels
            self.time_proj = Dense(temb_dim, n_out)
        self.norm2 = FusedGroupNorm(out_channels, groups, silu=True)
        self._add_conv3x3("conv2", out_channels, out_channels)
        if in_channels != out_channels:
            self.skip = Conv(in_channels, out_channels, (1, 1))

    def _add_conv3x3(self, name: str, cin: int, cout: int) -> None:
        if self.separable:
            setattr(self, f"{name}_dw", Conv(cin, cin, (3, 3), groups=cin))
            setattr(self, f"{name}_pw", Conv(cin, cout, (1, 1)))
        else:
            setattr(self, name, Conv(cin, cout, (3, 3)))

    def _conv3x3(self, name: str, h: torch.Tensor) -> torch.Tensor:
        if self.separable:
            return getattr(self, f"{name}_pw")(getattr(self, f"{name}_dw")(h))
        return getattr(self, name)(h)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        was_4d = x.dim() == 4
        xf, t = fold_time(x)
        h = self._conv3x3("conv1", self.norm1(xf))
        if temb is not None:
            # temb [B, D] (repeated over frames) or [(B T), D] (per-frame)
            ss = self.time_proj(F.silu(temb))
            if ss.shape[0] != h.shape[0]:
                ss = ss.repeat_interleave(t, dim=0)
            ss = ss[:, None, None, :]
            if self.temb_mode == "scale_shift":
                scale, shift = ss.chunk(2, dim=-1)
                h = self.norm2(h, silu=False)
                h = F.silu(h * (1.0 + scale) + shift)
            else:
                h = self.norm2(h + ss)
        else:
            h = self.norm2(h)
        h = self._conv3x3("conv2", h)
        if hasattr(self, "skip"):
            xf = self.skip(xf)
        out = xf + h
        return out if was_4d else unfold_time(out, t)


class Downsample(nn.Module):
    """Strided 3x3 conv. padding ((1,1),(1,1)) is the SD-UNet convention;
    "SAME" gives the asymmetric (0,1) pad of the SD-VAE encoder."""

    def __init__(self, in_channels: int, out_channels: int, padding=((1, 1), (1, 1))):
        super().__init__()
        self.Conv_0 = Conv(in_channels, out_channels, (3, 3), stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        was_4d = x.dim() == 4
        xf, t = fold_time(x)
        h = self.Conv_0(xf)
        return h if was_4d else unfold_time(h, t)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, 2H, 2W, C], each pixel repeated 2x2 (the
    reference's jax.image.resize(..., "nearest"))."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)


class Upsample(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.Conv_0 = Conv(in_channels, out_channels, (3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        was_4d = x.dim() == 4
        xf, t = fold_time(x)
        out = self.Conv_0(upsample_nearest2x(xf))
        return out if was_4d else unfold_time(out, t)
