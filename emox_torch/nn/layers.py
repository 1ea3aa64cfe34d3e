"""Parameterised layers with flax.linen semantics on channels-last tensors.

The reference builds its models from flax.linen Dense, Conv and LayerNorm.
These are their counterparts, with PyTorch's parameter layouts (Linear
weight [out, in], Conv weight [out, in/groups, *kernel]) so the weight
bridge is a rename plus a transpose:

  * Dense: F.linear; input cast to the weight's type (flax's `dtype`).
  * Conv: channels-last input [N, *spatial, C] as in the reference. The
    channels-last tensor is handed to cuDNN / oneDNN as a permuted view
    (for 2-D, an NCHW tensor in channels_last memory format), so no layout
    copy is made around the convolution. Padding "SAME" reproduces flax's
    split: for a stride-2 3x3 on an even size that is (0, 1), not (1, 1).
  * LayerNorm: statistics in fp32 with the fast variance E[x^2] - E[x]^2
    clipped at 0, normalise and affine in fp32, round once to x's type.

Parameters are created uninitialised; `init_weights` fills a whole model
from a torch.Generator (the port's own init: lecun-normal kernels, zero
biases, unit norm scales, zero-init where the reference zero-inits).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]


class Dense(nn.Module):
    # under tensor parallelism, the layer's role (emox_torch.comm.sharding.DenseShard)
    tp = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.linear(self, x)
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)

    def fan_in(self) -> int:
        return self.weight.shape[1]


class Conv(nn.Module):
    """flax.linen.Conv counterpart: 1-D ([N, L, C]) or 2-D ([N, H, W, C])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Sequence[int],
                 stride: int = 1, padding: Padding = "SAME", groups: int = 1, bias: bool = True,
                 zero_init: bool = False):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        if len(self.kernel_size) not in (1, 2):
            raise ValueError(f"Conv takes 1-D or 2-D kernels, got {kernel_size}")
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def fan_in(self) -> int:
        return math.prod(self.weight.shape[1:])

    def _pads(self, spatial: Sequence[int]):
        if self.padding == "VALID":
            return [(0, 0)] * len(spatial)
        if self.padding == "SAME":
            pads = []
            for size, k in zip(spatial, self.kernel_size):
                out = -(-size // self.stride)
                total = max((out - 1) * self.stride + k - size, 0)
                pads.append((total // 2, total - total // 2))
            return pads
        return [tuple(p) for p in self.padding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        nd = len(self.kernel_size)
        perm_in = (0, nd + 1, *range(1, nd + 1))  # channels-last -> channels-first view
        perm_out = (0, *range(2, nd + 2), 1)
        xc = x.permute(*perm_in)
        pads = self._pads(x.shape[1:1 + nd])
        conv = F.conv1d if nd == 1 else F.conv2d
        if all(lo == hi for lo, hi in pads):
            y = conv(xc, self.weight, self.bias, self.stride, [lo for lo, _ in pads], 1, self.groups)
        else:
            flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last dim first
            y = conv(F.pad(xc, flat), self.weight, self.bias, self.stride, 0, 1, self.groups)
        return y.permute(*perm_out)


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_in, n_out] fp32 weights of jax.image.resize's "bilinear" method
    along one axis: a triangle kernel widened by the downscale factor
    (antialiasing), normalised per output sample."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Channels-last [B, H, W, C] -> [B, h, w, C], as jax.image.resize(...,
    "bilinear") resizes (antialiased when shrinking), in fp32, rounded to
    x's type."""
    wy = resize_weights(x.shape[1], h, x.device)
    wx = resize_weights(x.shape[2], w, x.device)
    return torch.einsum("bijc,ih,jw->bhwc", x.float(), wy, wx).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """flax LayerNorm over the last axis (see the module docstring)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(x.dtype)


class AffineNorm(nn.Module):
    """Base of the normalisation layers: per-channel `weight` (flax `scale`)
    and `bias`."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))


class LayerNorm(AffineNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of `model` from `generator` (on the parameters'
    device): Dense/Conv kernels lecun-normal (std 1/sqrt(fan_in)) or zero
    where the module zero-inits, biases zero, norm scales one. A module may
    list extra parameters in `normal_init` ({name: std})."""
    for mod in model.modules():
        if isinstance(mod, (Dense, Conv)):
            w = mod.weight
            if mod.zero_init:
                w.zero_()
            else:
                w.copy_(torch.randn(w.shape, generator=generator, device=w.device, dtype=torch.float32)
                        / math.sqrt(mod.fan_in()))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, AffineNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        for name, std in getattr(mod, "normal_init", {}).items():
            p = getattr(mod, name)
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32) * std)
    return model
