"""The ControlNet conditioning encoder (counterpart of emox/models/controlnet.py).

A copy of the denoiser's down and mid path that reads a pixel-space
conditioning signal (a landmark-skeleton or pose render, a dense motion
field) and emits one additive residual per UNet skip connection and one for
the mid block, each through a zero-initialised 1x1 convolution. The
conditioning embedding's last convolution is zero-initialised too, so an
untrained ControlNet is an exact no-op.

NHWC with frames folded into the batch, as the UNet. The residuals are
returned as `ControlSignals` and handed to UNet.forward(control=...).
Attribute names are the flax submodule names, so the weight bridge is a
rename plus a transpose; `controlnet_params_from_unet` seeds the shared
trunk from a trained denoiser's state dict.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.core.config import ModelConfig
from emox_torch.models.unet import attention_heads
from emox_torch.nn.attention_blocks import SpatialTransformer
from emox_torch.nn.blocks import Downsample, ResBlock, fold_time, unfold_time
from emox_torch.nn.embeddings import TimestepEmbedder
from emox_torch.nn.layers import Conv


class ControlSignals(NamedTuple):
    """Additive residuals for the denoiser.

    down: one [(B T), h_i, w_i, c_i] tensor per UNet skip connection, in
          skip order (conv_in first).
    mid:  [(B T), h_mid, w_mid, c_mid].
    """

    down: List[torch.Tensor]
    mid: torch.Tensor

    def scaled(self, scale: float) -> "ControlSignals":
        """The conditioning_scale knob."""
        return ControlSignals([d * scale for d in self.down], self.mid * scale)


def cond_downs(cond_size: int, latent_size: int) -> int:
    """Stride-2 stages from the conditioning's size to the latent's, as the
    reference derives them from the shapes."""
    return max(0, (cond_size // latent_size).bit_length() - 1)


class ConditioningEmbedding(nn.Module):
    """Pixel-space conditioning [N, H, W, C_cond] -> latent-res features:
    a conv stack with stride-2 downsamples and a zero-init final conv."""

    def __init__(self, in_channels: int, out_channels: int, num_downs: int = 3,
                 features: Tuple[int, ...] = (16, 32, 96)):
        super().__init__()
        self.num_downs = num_downs
        last = len(features) - 1
        self.conv_in = Conv(in_channels, features[0], (3, 3))
        prev = features[0]
        for i in range(num_downs):
            f_in, f_out = features[min(i, last)], features[min(i + 1, last)]
            setattr(self, f"conv_{i}a", Conv(prev, f_in, (3, 3)))
            setattr(self, f"conv_{i}b", Conv(f_in, f_out, (3, 3), stride=2))
            prev = f_out
        self.conv_out = Conv(prev, out_channels, (3, 3), zero_init=True)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(cond))
        for i in range(self.num_downs):
            h = F.silu(getattr(self, f"conv_{i}a")(h))
            h = F.silu(getattr(self, f"conv_{i}b")(h))
        return self.conv_out(h)


class ControlNetEncoder(nn.Module):
    """The UNet's down and mid path emitting zero-conv residuals, with the
    UNet's names for the shared trunk so that the residual list aligns 1:1
    with the UNet's skips.

    Its SpatialTransformers always carry the text cross-attention (`attn2`):
    with no context they attend to a learned `null_context`."""

    def __init__(self, cfg: ModelConfig, cond_num_downs: int = 3, spatial_depth: int = 1):
        """cond_num_downs: stride-2 stages of the conditioning embedding,
        log2 of the VAE's downscale (the reference derives it from the
        conditioning at init)."""
        super().__init__()
        self.cfg = cfg
        chans = list(cfg.block_channels)
        temb_dim = 4 * cfg.base_channels
        g = cfg.norm_groups
        # the reference creates attn2 and null_context only where a context
        # reaches them: with any attention level, always (the null one)
        self.use_cross = bool(cfg.attention_levels)
        self.time_embed = TimestepEmbedder(temb_dim, cfg.base_channels)
        if self.use_cross:
            self.null_context = nn.Parameter(torch.empty(1, 1, cfg.cross_attention_dim))
            self.normal_init = {"null_context": 0.02}
        self.conv_in = Conv(cfg.in_channels, chans[0], (3, 3))
        self.cond_embed = ConditioningEmbedding(cfg.control_cond_channels, chans[0], num_downs=cond_num_downs)

        res = lambda cin, cout: ResBlock(cin, cout, groups=g, temb_dim=temb_dim, temb_mode=cfg.resnet_temb_mode,
                                         separable=cfg.separable_convs)
        zero = lambda c: Conv(c, c, (1, 1), zero_init=True)
        self.zero_conv_0 = zero(chans[0])
        zi, prev = 1, chans[0]
        for level, ch in enumerate(chans):
            for i in range(cfg.layers_per_block):
                setattr(self, f"down_{level}_res_{i}", res(prev, ch))
                prev = ch
                if level in cfg.attention_levels:
                    setattr(self, f"down_{level}_{i}_attn", self._transformer(ch, spatial_depth))
                setattr(self, f"zero_conv_{zi}", zero(ch))
                zi += 1
            if level < len(chans) - 1:
                setattr(self, f"down_{level}_ds", Downsample(ch, ch))
                setattr(self, f"zero_conv_{zi}", zero(ch))
                zi += 1
        self.mid_res_0 = res(chans[-1], chans[-1])
        self.mid_attn = self._transformer(chans[-1], spatial_depth)
        self.mid_res_1 = res(chans[-1], chans[-1])
        setattr(self, f"zero_conv_{zi}", zero(chans[-1]))
        self.num_zero_convs = zi + 1

    def _transformer(self, ch: int, depth: int) -> SpatialTransformer:
        cfg = self.cfg
        heads, head_dim = attention_heads(cfg, ch)
        return SpatialTransformer(ch, heads, head_dim, depth=depth, groups=cfg.norm_groups,
                                  use_cross=self.use_cross, cross_dim=cfg.cross_attention_dim)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, h, w, C_in] or [B, h, w, C_in] noisy latents
        timesteps: torch.Tensor,  # [B]
        cond: torch.Tensor,  # [B, H, W, C_cond] per clip or [B, T, H, W, C_cond] per frame, pixel space
        context: Optional[torch.Tensor] = None,  # [B, Lc, cross_dim]
        conditioning_scale: float = 1.0,
    ) -> ControlSignals:
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        if x.dim() == 4:
            x = x[:, None]
        b, t = x.shape[:2]
        temb = self.time_embed(timesteps)
        if context is None and self.use_cross:
            context = self.null_context.expand(b, 1, cfg.cross_attention_dim).to(dtype)

        h, _ = fold_time(x.to(dtype))
        h = self.conv_in(h)
        # the conditioning image at latent resolution, added at conv_in: one
        # per clip (4-D, repeated over the frames) or one per frame (5-D)
        size = cond.shape[1] if cond.dim() == 4 else cond.shape[2]
        if cond_downs(size, x.shape[2]) != self.cond_embed.num_downs:
            raise ValueError(f"control conditioning of {size}px does not match latents of {x.shape[2]} "
                             f"(the conditioning embedding has {self.cond_embed.num_downs} stride-2 stages)")
        if cond.dim() == 4:
            ce = self.cond_embed(cond.to(dtype)).repeat_interleave(t, dim=0)
        else:
            ce = self.cond_embed(fold_time(cond.to(dtype))[0])
        h = h + ce

        def resblock(name, h):
            return fold_time(getattr(self, name)(unfold_time(h, t), temb))[0]

        def attn(name, h):
            # the context per clip, repeated over the clip's frames inside
            return getattr(self, name)(h, context=context, num_frames=t, emit_bank=False)[0]

        residuals = [self.zero_conv_0(h)]
        zi = 1
        chans = cfg.block_channels
        for level in range(len(chans)):
            for i in range(cfg.layers_per_block):
                h = resblock(f"down_{level}_res_{i}", h)
                if level in cfg.attention_levels:
                    h = attn(f"down_{level}_{i}_attn", h)
                residuals.append(getattr(self, f"zero_conv_{zi}")(h))
                zi += 1
            if level < len(chans) - 1:
                h = fold_time(getattr(self, f"down_{level}_ds")(unfold_time(h, t)))[0]
                residuals.append(getattr(self, f"zero_conv_{zi}")(h))
                zi += 1
        h = resblock("mid_res_0", h)
        h = attn("mid_attn", h)
        h = resblock("mid_res_1", h)
        sig = ControlSignals(down=residuals, mid=getattr(self, f"zero_conv_{zi}")(h))
        return sig if conditioning_scale == 1.0 else sig.scaled(conditioning_scale)


def controlnet_params_from_unet(unet_state: Dict[str, torch.Tensor],
                                controlnet_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Seed a ControlNetEncoder state dict from a trained denoiser's: every
    top-level entry (a submodule such as `down_0_res_0`, or a parameter such
    as `null_context`) that the ControlNet shares with the denoiser, with the
    same leaves of the same shapes, is copied; the zero convs and the
    conditioning embedding keep their init."""

    def entries(state):
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, value in state.items():
            top, _, rest = key.partition(".")
            out.setdefault(top, {})[rest] = value
        return out

    src = entries(unet_state)
    out = dict(controlnet_state)
    for top, leaves in entries(controlnet_state).items():
        theirs = src.get(top)
        if theirs is not None and set(theirs) == set(leaves) and all(
                theirs[k].shape == v.shape for k, v in leaves.items()):
            for k in leaves:
                out[f"{top}.{k}" if k else top] = theirs[k]
    return out
