"""AutoencoderKL-shaped VAE, NHWC (counterpart of emox/models/vae.py).

Conv encoder with channel multipliers, single-head mid-block attention,
diagonal-Gaussian latent, symmetric decoder. Serving uses the posterior
mode; training draws a posterior sample from noise the caller supplies.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from emox_torch.core.config import VAEConfig
from emox_torch.nn.attention_blocks import Attention
from emox_torch.nn.blocks import Downsample, FusedGroupNorm, ResBlock, Upsample
from emox_torch.nn.layers import Conv


class DiagonalGaussian:
    """Latent distribution: moments [..., 2*C] -> sample / mode / kl."""

    def __init__(self, moments: torch.Tensor):
        mean, logvar = moments.chunk(2, dim=-1)
        self.mean = mean
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """mean + std * eps, with eps ~ N(0, 1) of the mean's shape drawn by
        the caller (cast to the mean's type, as the reference draws it)."""
        return self.mean + self.std * eps.reshape(self.mean.shape).to(device=self.mean.device,
                                                                      dtype=self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        return 0.5 * torch.sum(self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar, dim=(-3, -2, -1))


class MidAttention(nn.Module):
    """Single-head full attention over H*W tokens (SD VAE mid block)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.norm = FusedGroupNorm(channels, groups)
        self.attn = Attention(channels, heads=1, head_dim=channels, qkv_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        out = self.attn(self.norm(x).reshape(n, h * w, c))
        return x + out.reshape(n, h, w, c)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = [cfg.base_channels * m for m in cfg.channel_multipliers]
        self.chans = chans
        self.num_res_blocks = cfg.num_res_blocks
        g = cfg.norm_groups
        self.conv_in = Conv(cfg.in_channels, chans[0], (3, 3))
        prev = chans[0]
        for level, ch in enumerate(chans):
            for i in range(cfg.num_res_blocks):
                setattr(self, f"down_{level}_res_{i}", ResBlock(prev, ch, groups=g))
                prev = ch
            if level < len(chans) - 1:
                setattr(self, f"down_{level}_ds", Downsample(ch, ch, padding="SAME"))
        self.mid_res_0 = ResBlock(chans[-1], chans[-1], groups=g)
        self.mid_attn = MidAttention(chans[-1], groups=g)
        self.mid_res_1 = ResBlock(chans[-1], chans[-1], groups=g)
        self.norm_out = FusedGroupNorm(chans[-1], g, silu=True)
        self.conv_out = Conv(chans[-1], 2 * cfg.latent_channels, (3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in range(len(self.chans)):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h)
            if level < len(self.chans) - 1:
                h = getattr(self, f"down_{level}_ds")(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = [cfg.base_channels * m for m in cfg.channel_multipliers]
        self.chans = chans
        self.num_res_blocks = cfg.num_res_blocks
        g = cfg.norm_groups
        self.conv_in = Conv(cfg.latent_channels, chans[-1], (3, 3))
        self.mid_res_0 = ResBlock(chans[-1], chans[-1], groups=g)
        self.mid_attn = MidAttention(chans[-1], groups=g)
        self.mid_res_1 = ResBlock(chans[-1], chans[-1], groups=g)
        prev = chans[-1]
        for level, ch in reversed(list(enumerate(chans))):
            for i in range(cfg.num_res_blocks + 1):
                setattr(self, f"up_{level}_res_{i}", ResBlock(prev, ch, groups=g))
                prev = ch
            if level > 0:
                setattr(self, f"up_{level}_us", Upsample(ch, ch))
        self.norm_out = FusedGroupNorm(chans[0], g, silu=True)
        self.conv_out = Conv(chans[0], cfg.in_channels, (3, 3))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for level in reversed(range(len(self.chans))):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_res_{i}")(h)
            if level > 0:
                h = getattr(self, f"up_{level}_us")(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """encode: image [B, H, W, 3] in [-1, 1] -> DiagonalGaussian over
    [B, H/8, W/8, 4]; decode: latent -> image. Callers multiply by
    cfg.scaling_factor after taking the latent (SD convention)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, (1, 1))
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels, (1, 1))

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor):
        dist = self.encode(x)
        return self.decode(dist.mode()), dist
