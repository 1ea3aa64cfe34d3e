"""The UNet: one module, two roles (counterpart of emox/models/unet.py).

Role 1 (ReferenceNet / "writer"): run on the reference-image latent with
`emit_ref=True`; every spatial transformer site returns its pre-attention
LayerNormed tokens.

Role 2 (denoiser / "reader"): run on noisy video latents with
`ref_features=` from role 1 (each site appends the writer tokens to its
self-attention K/V), plus audio cross-attention after each spatial
transformer, speed buckets added to the per-frame time embedding, the
pre-encoded face-mask residual added after conv_in, and temporal attention
at every attention site and the mid block.

NHWC, frames folded into the batch for all spatial ops. With cfg.remat
(the default) and grad enabled, every spatial, audio and temporal
transformer runs under activation checkpointing, as the reference wraps
them in nn.remat: their activations are recomputed in the backward pass
instead of stored. With cfg.use_gn_ref the writer also emits each site's
fp32 spatial (mean, var) of its activations (`ref_gn`), and the reader
renormalises its own activations to them after each spatial transformer
(AdaIN). ControlNet residuals and the identity embedding wait for later
slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from emox_torch.core.config import ModelConfig
from emox_torch.nn.attention_blocks import AudioCrossAttention, SpatialTransformer, TemporalTransformer
from emox_torch.nn.blocks import Downsample, FusedGroupNorm, ResBlock, Upsample, fold_time, unfold_time
from emox_torch.nn.conditioners import FaceMaskEncoder, SpeedEncoder
from emox_torch.nn.embeddings import TimestepEmbedder
from emox_torch.nn.layers import Conv

_DEFERRED = {
    "use_controlnet": "ControlNet (ROADMAP.md, Queue 1 item 7)",
    "use_identity_embed": "the CLIP identity embedding (ROADMAP.md, Queue 1 item 7)",
    "use_sparse_causal": "sparse-causal attention (ROADMAP.md, Queue 1 item 3)",
    "separable_convs": "separable ResBlock convs (ROADMAP.md, Queue 1 item 2)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for model options outside the port so far."""
    for name, what in _DEFERRED.items():
        if getattr(cfg, name):
            raise NotImplementedError(f"model.{name}=True: {what} waits for a later slice of the port")


class UNetOutputs(NamedTuple):
    sample: torch.Tensor
    ref_features: Optional[List[List[torch.Tensor]]]  # per attention site, per depth block
    # per attention site [B, 1, 1, C, 2] fp32 (spatial mean, var) of the
    # writer's activations: the AdaIN statistic banks (cfg.use_gn_ref)
    ref_gn: Optional[List[torch.Tensor]] = None


def _spatial_stats(h: torch.Tensor):
    """h [N, H, W, C] in fp32, and its mean and var over H and W, each [N, 1, 1, C]."""
    x = h.float()
    m = x.mean(dim=(1, 2), keepdim=True)
    return x, m, x.square().mean(dim=(1, 2), keepdim=True) - m.square()


def _adain(h: torch.Tensor, stats: torch.Tensor, t: int, style_fidelity: float,
           drop: Optional[torch.Tensor]) -> torch.Tensor:
    """Renormalise h [(B T), H, W, C] to the writer's spatial statistics
    stats [B, 1, 1, C, 2]. drop: [(B T)] bool, True = an uncond/no-reference
    sample, which keeps style_fidelity of its own statistics."""
    x, m, v = _spatial_stats(h)
    std = torch.sqrt(v.clamp_min(1e-6))
    mr = stats[..., 0].repeat_interleave(t, dim=0)
    sr = torch.sqrt(stats[..., 1].repeat_interleave(t, dim=0).clamp_min(1e-6))
    x_uc = (x - m) / std * sr + mr
    if drop is None:
        out = x_uc  # every sample conditioned: sf*x_uc + (1-sf)*x_uc = x_uc
    else:
        d = drop.reshape(-1, 1, 1, 1).float()
        x_c = x * d + x_uc * (1.0 - d)  # uncond keeps its own stats in the x_c term
        out = style_fidelity * x_c + (1.0 - style_fidelity) * x_uc
    return out.to(h.dtype)


class UNet(nn.Module):
    def __init__(self, cfg: ModelConfig, face_mask_downs: int = 3, spatial_depth: int = 1):
        """face_mask_downs: stride-2 convs of the face-mask encoder, log2 of
        the VAE's downscale (the reference derives it from the mask at init)."""
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        chans = list(cfg.block_channels)
        temb_dim = 4 * cfg.base_channels
        g = cfg.norm_groups
        self.time_embed = TimestepEmbedder(temb_dim, cfg.base_channels)
        if cfg.use_speed:
            self.speed_embed = SpeedEncoder(
                temb_dim, cfg.speed_axes, cfg.num_speed_buckets, cfg.speed_bucket_radius
            )
        self.has_null_context = bool(cfg.attention_levels) and cfg.use_cross_attention
        if self.has_null_context:
            self.null_context = nn.Parameter(torch.empty(1, 1, cfg.cross_attention_dim))
            self.normal_init = {"null_context": 0.02}
        self.conv_in = Conv(cfg.in_channels, chans[0], (3, 3))
        if cfg.use_face_mask:
            self.face_mask_encoder = FaceMaskEncoder(chans[0], num_downs=face_mask_downs)

        res = lambda cin, cout: ResBlock(cin, cout, groups=g, temb_dim=temb_dim, temb_mode=cfg.resnet_temb_mode)
        skips = [chans[0]]
        prev = chans[0]
        for level, ch in enumerate(chans):
            for i in range(cfg.layers_per_block):
                setattr(self, f"down_{level}_res_{i}", res(prev, ch))
                prev = ch
                if level in cfg.attention_levels:
                    self._add_attn_stack(f"down_{level}_{i}", ch, spatial_depth)
                skips.append(ch)
            if level < len(chans) - 1:
                setattr(self, f"down_{level}_ds", Downsample(ch, ch))
                skips.append(ch)
        self.mid_res_0 = res(chans[-1], chans[-1])
        self._add_attn_stack("mid", chans[-1], spatial_depth)
        self.mid_res_1 = res(chans[-1], chans[-1])
        for level, ch in reversed(list(enumerate(chans))):
            for i in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{level}_res_{i}", res(prev + skips.pop(), ch))
                prev = ch
                if level in cfg.attention_levels:
                    self._add_attn_stack(f"up_{level}_{i}", ch, spatial_depth)
            if level > 0:
                setattr(self, f"up_{level}_us", Upsample(ch, ch))
        self.norm_out = FusedGroupNorm(chans[0], g, silu=True)
        self.conv_out = Conv(chans[0], cfg.out_channels, (3, 3))

    def _heads(self, ch: int):
        """(heads, head_dim): fixed head count when cfg.attention_heads > 0,
        else the fixed head dim."""
        if self.cfg.attention_heads > 0:
            return self.cfg.attention_heads, ch // self.cfg.attention_heads
        return max(1, ch // self.cfg.attention_head_dim), self.cfg.attention_head_dim

    def _add_attn_stack(self, name: str, ch: int, depth: int) -> None:
        cfg = self.cfg
        heads, head_dim = self._heads(ch)
        setattr(self, f"{name}_attn", SpatialTransformer(
            ch, heads, head_dim, depth=depth, groups=cfg.norm_groups,
            use_cross=cfg.use_cross_attention, cross_dim=cfg.cross_attention_dim,
        ))
        if cfg.use_audio:
            setattr(self, f"{name}_audio", AudioCrossAttention(ch, heads, head_dim, cfg.audio_context_dim))
        if cfg.use_temporal:
            setattr(self, f"{name}_temporal", TemporalTransformer(ch, heads, head_dim, max_len=cfg.temporal_pos_max_len))

    def forward(
        self,
        x: torch.Tensor,  # [B, T, h, w, C_in] or [B, h, w, C_in]
        timesteps: torch.Tensor,  # [B]
        context: Optional[torch.Tensor] = None,  # [B, Lc, cross_dim]
        ref_features: Optional[List[List[torch.Tensor]]] = None,
        ref_gn: Optional[List[torch.Tensor]] = None,  # per site [B, 1, 1, C, 2] writer stats
        audio: Optional[torch.Tensor] = None,  # [B, T, A, audio_dim]
        speeds: Optional[torch.Tensor] = None,  # [B], [B, T] or [B, T, axes]
        face_mask: Optional[torch.Tensor] = None,  # [B, H, W, 1] pixel space
        face_feat: Optional[torch.Tensor] = None,  # [B, h, w, C0] PRE-ENCODED mask residual
        emit_ref: bool = False,
        ref_dropout: Optional[torch.Tensor] = None,  # [B] bool, True = this sample sees no ref
    ) -> UNetOutputs:
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        if not cfg.use_reference:
            ref_features = None
            ref_gn = None
        squeeze = x.dim() == 4
        if squeeze:
            x = x[:, None]
        b, t = x.shape[:2]

        # ---- embeddings -------------------------------------------------
        temb = self.time_embed(timesteps)
        if cfg.use_speed and speeds is not None:
            if speeds.dim() == 1:
                speeds = speeds[:, None].expand(b, t)
            axes = speeds.shape[2] if speeds.dim() == 3 else 1
            spe = self.speed_embed(speeds.reshape(b * t, axes))
            temb = temb.repeat_interleave(t, dim=0) + spe  # [(B T), D] per-frame
        if self.has_null_context and context is None:
            context = self.null_context.expand(b, 1, cfg.cross_attention_dim).to(dtype)

        # ---- conv_in + face mask residual -------------------------------
        h, _ = fold_time(x.to(dtype))
        h = self.conv_in(h)
        if cfg.use_face_mask and (face_mask is not None or face_feat is not None):
            mf = face_feat if face_feat is not None else self.face_mask_encoder(face_mask)
            h = h + mf.to(dtype).repeat_interleave(t, dim=0)

        banks: List[List[torch.Tensor]] = []
        gn_banks: List[torch.Tensor] = []
        site = 0
        drop_frames = None if ref_dropout is None else ref_dropout.repeat_interleave(t, dim=0)
        remat = cfg.remat and torch.is_grad_enabled()
        # cfg.flash_attention=False pins every attention of this UNet to the
        # plain path ("xla"); True keeps the dispatcher's default. The
        # process-wide EMOX_ATTENTION_IMPL beats both, as in the reference.
        impl = None if (cfg.flash_attention or os.environ.get("EMOX_ATTENTION_IMPL")) else "xla"

        def run(mod, *args, **kwargs):
            if remat:
                return checkpoint(mod, *args, use_reentrant=False, **kwargs)
            return mod(*args, **kwargs)

        def attn_stack(h, name):
            """spatial (+ref) -> audio cross -> temporal, at one site."""
            nonlocal site
            rkv = None
            if ref_features is not None and not emit_ref:
                rkv = list(ref_features[site])
            # emit_bank: the writer's banks; the reader then skips a LayerNorm
            # that the fused LN + q/k/v kernel (EMOX_LN_QKV) made unnecessary
            h, bank = run(
                getattr(self, f"{name}_attn"), h, context=context, ref_kv=rkv,
                ref_drop=None if rkv is None else drop_frames, num_frames=1 if emit_ref else t,
                emit_bank=emit_ref, impl=impl,
            )
            if emit_ref:
                banks.append(bank)
                if cfg.use_gn_ref:
                    _, m, v = _spatial_stats(h)
                    gn_banks.append(torch.stack([m, v], dim=-1))
            elif cfg.use_gn_ref and ref_gn is not None:
                h = _adain(h, ref_gn[site], t, cfg.style_fidelity, drop_frames)
            site += 1
            hv = unfold_time(h, t)
            if cfg.use_audio and audio is not None:
                hv = run(getattr(self, f"{name}_audio"), hv, audio, impl=impl)
            if cfg.use_temporal and t > 1:
                hv = run(getattr(self, f"{name}_temporal"), hv)
            return fold_time(hv)[0]

        def resblock(name, h):
            return fold_time(getattr(self, name)(unfold_time(h, t), temb))[0]

        # ---- down path ---------------------------------------------------
        chans = cfg.block_channels
        skips = [h]
        for level in range(len(chans)):
            for i in range(cfg.layers_per_block):
                h = resblock(f"down_{level}_res_{i}", h)
                if level in cfg.attention_levels:
                    h = attn_stack(h, f"down_{level}_{i}")
                skips.append(h)
            if level < len(chans) - 1:
                h = fold_time(getattr(self, f"down_{level}_ds")(unfold_time(h, t)))[0]
                skips.append(h)

        # ---- mid ---------------------------------------------------------
        h = resblock("mid_res_0", h)
        h = attn_stack(h, "mid")
        h = resblock("mid_res_1", h)

        # ---- up path -----------------------------------------------------
        for level in reversed(range(len(chans))):
            for i in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = resblock(f"up_{level}_res_{i}", h)
                if level in cfg.attention_levels:
                    h = attn_stack(h, f"up_{level}_{i}")
            if level > 0:
                h = fold_time(getattr(self, f"up_{level}_us")(unfold_time(h, t)))[0]

        # ---- out ---------------------------------------------------------
        h = self.conv_out(self.norm_out(h))
        out = unfold_time(h, t)
        if squeeze:
            out = out[:, 0]
        return UNetOutputs(sample=out, ref_features=banks if emit_ref else None,
                           ref_gn=gn_banks if (emit_ref and cfg.use_gn_ref) else None)


def reference_net_config(cfg: ModelConfig) -> ModelConfig:
    """The 2D ReferenceNet config from the denoiser config: same topology (so
    attention sites align 1:1), no video-only conditioning."""
    return dataclasses.replace(cfg, use_temporal=False, use_audio=False, use_speed=False, use_face_mask=False)
