"""Plain float32 reference of the EMO model that the benchmark holds emox_torch to.

It is written from the architecture the port implements (an SD-1.5-shaped UNet inflated to
video, a ReferenceNet writer whose LayerNormed tokens join the reader's self-attention keys,
audio cross-attention and temporal attention at every attention site, speed buckets added to
the time embedding, a face-mask residual after conv_in, an AutoencoderKL, a wav2vec2-base
audio encoder and the CLIP text encoder), under the port's parameter names so that one state
dict feeds both sides. It imports nothing of emox_torch and nothing of JAX, and it calls no
hand-written kernel: plain torch operations, channels-last tensors [N, H, W, C], float32.

`Precision` decides how every matmul and convolution rounds its operands: "fp32" (the
reference) or "fp8" (the control of the lower precision: each operand scaled per tensor to
e4m3's range, rounded to float8_e4m3fn and widened again). The caller turns TF32 off.

`checkpoint=True` recomputes each block in the backward pass (memory only: the gradients are
the same). Attention runs in row chunks of at most ATTN_ELEMS scores.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

ATTN_ELEMS = 1 << 28  # scores of one chunk of the attention's rows: 1 GiB in float32

Shapes = Dict[str, Tuple[int, ...]]
Weights = Dict[str, torch.Tensor]

FP8_MAX = 448.0  # largest finite float8_e4m3fn


# ---- configuration helpers ----------------------------------------------------------------
def heads_of(m: dict, ch: int) -> Tuple[int, int]:
    """(heads, head_dim) of an attention at width ch: a fixed head count where the config
    gives one (SD-1.5's 8), else a fixed head width."""
    if m["attention_heads"] > 0:
        return m["attention_heads"], ch // m["attention_heads"]
    return max(1, ch // m["attention_head_dim"]), m["attention_head_dim"]


def writer_config(m: dict) -> dict:
    """The ReferenceNet's model section: the denoiser's topology without the video-only
    conditioning."""
    return dict(m, use_temporal=False, use_audio=False, use_speed=False, use_face_mask=False)


def vae_downscale(vae: dict) -> int:
    return 2 ** (len(vae["channel_multipliers"]) - 1)


def check_supported(cfg: dict) -> None:
    m = cfg["model"]
    off = ("use_sparse_causal", "use_controlnet", "use_identity_embed", "separable_convs", "use_gn_ref")
    on = [k for k in off if m.get(k)]
    if on or cfg["clip"].get("vision_enabled"):
        raise ValueError(f"the reference does not implement {on or ['clip.vision_enabled']}")
    if cfg["diffusion"]["prediction_type"] != "epsilon" or cfg["diffusion"]["ddim_eta"] != 0.0:
        raise ValueError("the reference samples epsilon-prediction DDIM with eta 0")


# ---- the parameter layout ------------------------------------------------------------------
class _Spec:
    def __init__(self):
        self.shapes: Shapes = {}

    def dense(self, name: str, i: int, o: int, bias: bool = True) -> None:
        self.shapes[f"{name}.weight"] = (o, i)
        if bias:
            self.shapes[f"{name}.bias"] = (o,)

    def conv(self, name: str, i: int, o: int, k: Sequence[int], groups: int = 1, bias: bool = True) -> None:
        self.shapes[f"{name}.weight"] = (o, i // groups, *k)
        if bias:
            self.shapes[f"{name}.bias"] = (o,)

    def norm(self, name: str, c: int) -> None:
        self.shapes[f"{name}.weight"] = (c,)
        self.shapes[f"{name}.bias"] = (c,)

    def resblock(self, name: str, cin: int, cout: int, temb: Optional[int] = None, mode: str = "scale_shift"):
        self.norm(f"{name}.norm1", cin)
        self.conv(f"{name}.conv1", cin, cout, (3, 3))
        if temb is not None:
            self.dense(f"{name}.time_proj", temb, 2 * cout if mode == "scale_shift" else cout)
        self.norm(f"{name}.norm2", cout)
        self.conv(f"{name}.conv2", cout, cout, (3, 3))
        if cin != cout:
            self.conv(f"{name}.skip", cin, cout, (1, 1))

    def attention(self, name: str, q_dim: int, inner: int, ctx_dim: int, qkv_bias: bool = False):
        self.dense(f"{name}.to_q", q_dim, inner, qkv_bias)
        self.dense(f"{name}.to_k", ctx_dim, inner, qkv_bias)
        self.dense(f"{name}.to_v", ctx_dim, inner, qkv_bias)
        self.dense(f"{name}.to_out", inner, q_dim)

    def geglu(self, name: str, c: int) -> None:
        self.dense(f"{name}.proj_in", c, 8 * c)
        self.dense(f"{name}.proj_out", 4 * c, c)

    def unet(self, p: str, m: dict, face_downs: int) -> None:
        chans = [m["base_channels"] * k for k in m["channel_multipliers"]]
        temb = 4 * m["base_channels"]
        self.dense(f"{p}.time_embed.fc1", m["base_channels"], temb)
        self.dense(f"{p}.time_embed.fc2", temb, temb)
        if m["use_speed"]:
            self.dense(f"{p}.speed_embed.fc1", m["speed_axes"] * m["num_speed_buckets"], temb)
            self.dense(f"{p}.speed_embed.fc2", temb, temb)
        if m["attention_levels"] and m["use_cross_attention"]:
            self.shapes[f"{p}.null_context"] = (1, 1, m["cross_attention_dim"])
        self.conv(f"{p}.conv_in", m["in_channels"], chans[0], (3, 3))
        if m["use_face_mask"]:
            ch = 1
            for i, f in enumerate((16, 32, 96)[:face_downs]):
                self.conv(f"{p}.face_mask_encoder.conv{i}", ch, f, (3, 3))
                ch = f
            self.conv(f"{p}.face_mask_encoder.zero_conv", ch, chans[0], (3, 3))
        res = lambda name, cin, cout: self.resblock(f"{p}.{name}", cin, cout, temb, m["resnet_temb_mode"])
        skips, prev = [chans[0]], chans[0]
        for level, ch in enumerate(chans):
            for i in range(m["layers_per_block"]):
                res(f"down_{level}_res_{i}", prev, ch)
                prev = ch
                if level in m["attention_levels"]:
                    self.attn_stack(f"{p}.down_{level}_{i}", m, ch)
                skips.append(ch)
            if level < len(chans) - 1:
                self.conv(f"{p}.down_{level}_ds.Conv_0", ch, ch, (3, 3))
                skips.append(ch)
        res("mid_res_0", chans[-1], chans[-1])
        self.attn_stack(f"{p}.mid", m, chans[-1])
        res("mid_res_1", chans[-1], chans[-1])
        for level, ch in reversed(list(enumerate(chans))):
            for i in range(m["layers_per_block"] + 1):
                res(f"up_{level}_res_{i}", prev + skips.pop(), ch)
                prev = ch
                if level in m["attention_levels"]:
                    self.attn_stack(f"{p}.up_{level}_{i}", m, ch)
            if level > 0:
                self.conv(f"{p}.up_{level}_us.Conv_0", ch, ch, (3, 3))
        self.norm(f"{p}.norm_out", chans[0])
        self.conv(f"{p}.conv_out", chans[0], m["out_channels"], (3, 3))

    def attn_stack(self, name: str, m: dict, ch: int) -> None:
        heads, hd = heads_of(m, ch)
        inner = heads * hd
        s = f"{name}_attn"
        self.norm(f"{s}.norm", ch)
        self.dense(f"{s}.proj_in", ch, ch)
        self.norm(f"{s}.block_0.norm1", ch)
        self.attention(f"{s}.block_0.attn1", ch, inner, ch)
        if m["use_cross_attention"]:
            self.norm(f"{s}.block_0.norm2", ch)
            self.attention(f"{s}.block_0.attn2", ch, inner, m["cross_attention_dim"])
        self.norm(f"{s}.block_0.norm3", ch)
        self.geglu(f"{s}.block_0.ff", ch)
        self.dense(f"{s}.proj_out", ch, ch)
        if m["use_audio"]:
            self.norm(f"{name}_audio.norm", ch)
            self.attention(f"{name}_audio.attn", ch, inner, m["audio_context_dim"])
        if m["use_temporal"]:
            t = f"{name}_temporal"
            self.norm(f"{t}.norm_in", ch)
            self.norm(f"{t}.norm_0", ch)
            self.attention(f"{t}.attn_0", ch, inner, ch)
            self.norm(f"{t}.norm_ff_0", ch)
            self.geglu(f"{t}.ff_0", ch)
            self.dense(f"{t}.proj_out", ch, ch)

    def vae(self, v: dict) -> None:
        chans = [v["base_channels"] * k for k in v["channel_multipliers"]]
        nrb, lat = v["num_res_blocks"], v["latent_channels"]
        e = "vae.encoder"
        self.conv(f"{e}.conv_in", v["in_channels"], chans[0], (3, 3))
        prev = chans[0]
        for level, ch in enumerate(chans):
            for i in range(nrb):
                self.resblock(f"{e}.down_{level}_res_{i}", prev, ch)
                prev = ch
            if level < len(chans) - 1:
                self.conv(f"{e}.down_{level}_ds.Conv_0", ch, ch, (3, 3))
        self._vae_mid(e, chans[-1])
        self.norm(f"{e}.norm_out", chans[-1])
        self.conv(f"{e}.conv_out", chans[-1], 2 * lat, (3, 3))
        d = "vae.decoder"
        self.conv(f"{d}.conv_in", lat, chans[-1], (3, 3))
        self._vae_mid(d, chans[-1])
        prev = chans[-1]
        for level, ch in reversed(list(enumerate(chans))):
            for i in range(nrb + 1):
                self.resblock(f"{d}.up_{level}_res_{i}", prev, ch)
                prev = ch
            if level > 0:
                self.conv(f"{d}.up_{level}_us.Conv_0", ch, ch, (3, 3))
        self.norm(f"{d}.norm_out", chans[0])
        self.conv(f"{d}.conv_out", chans[0], v["in_channels"], (3, 3))
        self.conv("vae.quant_conv", 2 * lat, 2 * lat, (1, 1))
        self.conv("vae.post_quant_conv", lat, lat, (1, 1))

    def _vae_mid(self, p: str, c: int) -> None:
        self.resblock(f"{p}.mid_res_0", c, c)
        self.norm(f"{p}.mid_attn.norm", c)
        self.attention(f"{p}.mid_attn.attn", c, c, c, qkv_bias=True)
        self.resblock(f"{p}.mid_res_1", c, c)

    def audio(self, a: dict) -> None:
        p, ch = "audio_encoder", 1
        for i, k in enumerate(a["conv_kernels"]):
            self.conv(f"{p}.feature_extractor.conv{i}", ch, a["conv_dim"], (k,), bias=False)
            ch = a["conv_dim"]
        self.norm(f"{p}.feature_extractor.gn0", a["conv_dim"])
        self.norm(f"{p}.feat_norm", a["conv_dim"])
        self.dense(f"{p}.feat_proj", a["conv_dim"], a["hidden_dim"])
        self.conv(f"{p}.pos_conv", a["hidden_dim"], a["hidden_dim"], (128,), groups=16)
        self.norm(f"{p}.enc_norm", a["hidden_dim"])
        d = a["hidden_dim"]
        for i in range(a["num_layers"]):
            self.attention(f"{p}.layer_{i}.attn", d, d, d, qkv_bias=True)
            self.norm(f"{p}.layer_{i}.norm1", d)
            self.dense(f"{p}.layer_{i}.ff1", d, 4 * d)
            self.dense(f"{p}.layer_{i}.ff2", 4 * d, d)
            self.norm(f"{p}.layer_{i}.norm2", d)

    def clip_text(self, c: dict) -> None:
        p, d = "clip_text", c["text_hidden_dim"]
        self.shapes[f"{p}.token_embedding.weight"] = (c["vocab_size"], d)
        self.shapes[f"{p}.position_embedding"] = (c["max_positions"], d)
        for i in range(c["text_layers"]):
            self.norm(f"{p}.layer_{i}.norm1", d)
            self.attention(f"{p}.layer_{i}.attn", d, d, d, qkv_bias=True)
            self.norm(f"{p}.layer_{i}.norm2", d)
            self.dense(f"{p}.layer_{i}.fc1", d, 4 * d)
            self.dense(f"{p}.layer_{i}.fc2", 4 * d, d)
        self.norm(f"{p}.final_norm", d)

    def face_nets(self) -> None:
        for net, head, out in (("face_locator", "head", 1), ("landmarker", "heat", 6)):
            ch = 3
            for i, f in enumerate((32, 64, 128)):
                self.conv(f"{net}.conv{i}", ch, f, (3, 3))
                ch = f
            self.conv(f"{net}.{head}", ch, out, (1, 1))


def param_shapes(cfg: dict) -> Shapes:
    """Every parameter of the model the configuration describes, by the port's name."""
    check_supported(cfg)
    s = _Spec()
    face_downs = max(0, vae_downscale(cfg["vae"]).bit_length() - 1)
    s.vae(cfg["vae"])
    s.unet("reference_net", writer_config(cfg["model"]), face_downs)
    s.unet("denoiser", cfg["model"], face_downs)
    s.audio(cfg["audio"])
    if cfg["clip"]["text_enabled"]:
        s.clip_text(cfg["clip"])
    s.face_nets()
    return s.shapes


# ---- precision -----------------------------------------------------------------------------
class Precision:
    """How every matmul and convolution operand is rounded: "fp32" leaves it, "fp8" rounds
    it through float8_e4m3fn under a per-tensor scale (the straight-through gradient
    where autograd records)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32" or x.device.type == "meta":
            return x
        with torch.no_grad():
            scale = x.abs().amax().float().clamp_min(1e-30) / FP8_MAX
            r = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (r - x).detach() if x.requires_grad else r


# ---- the model -----------------------------------------------------------------------------
def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class EMORef:
    """The model's pieces as functions of the weights `W` (float32, the port's names)."""

    def __init__(self, cfg: dict, W: Weights, precision: str = "fp32", checkpoint: bool = False):
        check_supported(cfg)
        self.cfg, self.W = cfg, W
        self.q = Precision(precision)
        self.ckpt = checkpoint

    # -- layers --
    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        b = self.W.get(f"{name}.bias")
        return F.linear(self.q(x), self.q(self.W[f"{name}.weight"]), b)

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, pads=None, groups: int = 1) -> torch.Tensor:
        """Channels-last x [N, *spatial, C]; pads per spatial dim (lo, hi), default "SAME"."""
        w = self.W[f"{name}.weight"]
        k = w.shape[2:]
        nd = len(k)
        if pads is None:
            pads = [_same_pads(x.shape[1 + i], k[i], stride) for i in range(nd)]
        xc = x.movedim(-1, 1)
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        if any(flat):
            xc = F.pad(xc, flat)
        fn = F.conv1d if nd == 1 else F.conv2d
        y = fn(self.q(xc), self.q(w), self.W.get(f"{name}.bias"), stride, 0, 1, groups)
        return y.movedim(1, -1)

    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.W[f"{name}.weight"], self.W[f"{name}.bias"], 1e-5)

    def group_norm(self, name: str, x: torch.Tensor, groups: int, silu: bool) -> torch.Tensor:
        """GroupNorm over a channels-last x [N, ..., C]: statistics over every position and
        the C/groups channels of a group."""
        n, c = x.shape[0], x.shape[-1]
        xg = x.reshape(n, -1, groups, c // groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
        y = y * self.W[f"{name}.weight"] + self.W[f"{name}.bias"]
        return F.silu(y) if silu else y

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
        """Softmax attention on [N, L, H*D] tokens, scale D^-1/2, in row chunks."""
        n, lq, inner = q.shape
        d = inner // heads
        split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)
        qh, kh, vh = split(q), split(k), split(v)
        rows = max(1, ATTN_ELEMS // max(1, heads * lq * k.shape[1]))

        def block(qb, kb, vb):
            s = torch.matmul(self.q(qb), self.q(kb).transpose(-1, -2)) * (d ** -0.5)
            return torch.matmul(self.q(torch.softmax(s, dim=-1)), self.q(vb))

        outs = []
        for i in range(0, n, rows):
            args = (qh[i:i + rows], kh[i:i + rows], vh[i:i + rows])
            outs.append(self.run(block, *args))
        o = torch.cat(outs) if len(outs) > 1 else outs[0]
        return o.transpose(1, 2).reshape(n, lq, inner)

    def run(self, fn, *args):
        """fn(*args), recomputed in the backward pass under checkpoint=True."""
        if self.ckpt and torch.is_grad_enabled() and any(torch.is_tensor(a) and a.requires_grad for a in args):
            return _checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def mha(self, name: str, x: torch.Tensor, heads: int, ctx: Optional[torch.Tensor] = None,
            extra: Optional[torch.Tensor] = None, extra_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Multi-head attention: keys from ctx (default x), with `extra` tokens (the writer's,
        one row per query row) appended to the keys and values; rows of extra_drop append
        their own tokens instead."""
        c = x if ctx is None else ctx
        qh, kk, vv = self.lin(f"{name}.to_q", x), self.lin(f"{name}.to_k", c), self.lin(f"{name}.to_v", c)
        if extra is not None:
            ke, ve = self.lin(f"{name}.to_k", extra), self.lin(f"{name}.to_v", extra)
            if extra_drop is not None:
                drop = extra_drop[:, None, None]
                ke, ve = torch.where(drop, kk, ke), torch.where(drop, vv, ve)
            kk, vv = torch.cat([kk, ke], dim=1), torch.cat([vv, ve], dim=1)
        return self.lin(f"{name}.to_out", self.attend(qh, kk, vv, heads))

    def geglu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        a, g = self.lin(f"{name}.proj_in", x).chunk(2, dim=-1)
        return self.lin(f"{name}.proj_out", a * F.gelu(g))

    def resblock(self, name: str, x: torch.Tensor, temb: Optional[torch.Tensor], groups: int,
                 mode: str = "scale_shift") -> torch.Tensor:
        """x [N, H, W, C]; temb [N or N/t, D]."""
        h = self.conv(f"{name}.conv1", self.group_norm(f"{name}.norm1", x, groups, True))
        if temb is not None:
            ss = self.lin(f"{name}.time_proj", F.silu(temb))
            if ss.shape[0] != h.shape[0]:
                ss = ss.repeat_interleave(h.shape[0] // ss.shape[0], dim=0)
            ss = ss[:, None, None, :]
            if mode == "scale_shift":
                scale, shift = ss.chunk(2, dim=-1)
                h = F.silu(self.group_norm(f"{name}.norm2", h, groups, False) * (1.0 + scale) + shift)
            else:
                h = self.group_norm(f"{name}.norm2", h + ss, groups, True)
        else:
            h = self.group_norm(f"{name}.norm2", h, groups, True)
        h = self.conv(f"{name}.conv2", h)
        skip = self.conv(f"{name}.skip", x) if f"{name}.skip.weight" in self.W else x
        return skip + h

    # -- time and conditioning --
    @staticmethod
    def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
        half = dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

    @staticmethod
    def positions(n: int, dim: int, device) -> torch.Tensor:
        pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
        div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / dim))
        pe = torch.zeros(n, dim, dtype=torch.float32, device=device)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)[:, : dim // 2]
        return pe

    def speed_embed(self, p: str, m: dict, speeds: torch.Tensor) -> torch.Tensor:
        """speeds [N, axes] -> [N, D]: tanh buckets around evenly spaced centres in [-1, 1]."""
        centers = torch.linspace(-1.0, 1.0, m["num_speed_buckets"], device=speeds.device)
        enc = torch.tanh((speeds.float()[..., None] - centers) / m["speed_bucket_radius"])
        h = F.silu(self.lin(f"{p}.speed_embed.fc1", enc.reshape(speeds.shape[0], -1)))
        return self.lin(f"{p}.speed_embed.fc2", h)

    def face_mask_feat(self, mask: torch.Tensor) -> torch.Tensor:
        """Face mask [B, H, W, 1] -> the denoiser's residual at latent size."""
        p = "denoiser.face_mask_encoder"
        h, i = mask.float(), 0
        while f"{p}.conv{i}.weight" in self.W:
            h = F.silu(self.conv(f"{p}.conv{i}", h, stride=2))
            i += 1
        return self.conv(f"{p}.zero_conv", h)

    # -- the UNet: writer (emit banks) and reader (reads them) --
    def unet(self, p: str, x: torch.Tensor, timesteps: torch.Tensor, *, context=None, banks=None,
             audio=None, speeds=None, face_feat=None, ref_drop=None, emit=False):
        """x [B, T, h, w, C] (or [B, h, w, C]); banks: per site the writer's tokens [B, L, C];
        audio [B, T, A, Da]; speeds [B, T, axes]; face_feat [B, h, w, C0]; ref_drop [B] bool.
        Returns (eps, banks emitted)."""
        m = self.cfg["model"] if p == "denoiser" else writer_config(self.cfg["model"])
        g = m["norm_groups"]
        squeeze = x.dim() == 4
        if squeeze:
            x = x[:, None]
        b, t = x.shape[:2]
        temb = self.lin(f"{p}.time_embed.fc2", F.silu(self.lin(
            f"{p}.time_embed.fc1", self.timestep_embedding(timesteps, m["base_channels"]))))
        if m["use_speed"] and speeds is not None:
            temb = temb.repeat_interleave(t, dim=0) + self.speed_embed(p, m, speeds.reshape(b * t, -1))
        if m["use_cross_attention"] and context is None:
            context = self.W[f"{p}.null_context"].expand(b, 1, m["cross_attention_dim"])
        h = self.conv(f"{p}.conv_in", x.float().reshape(b * t, *x.shape[2:]))
        if m["use_face_mask"] and face_feat is not None:
            h = h + face_feat.repeat_interleave(t, dim=0)
        drop = None if ref_drop is None else ref_drop.repeat_interleave(t, dim=0)
        out_banks: List[torch.Tensor] = []
        site = [0]
        mode = m["resnet_temb_mode"]

        def res(name, h):
            return self.run(lambda h, e: self.resblock(f"{p}.{name}", h, e, g, mode), h, temb)

        def stack(name, h):
            heads, _ = heads_of(m, h.shape[-1])
            bank = None if (emit or banks is None) else banks[site[0]]
            site[0] += 1
            h, normed = self.run(lambda h: self.spatial(f"{p}.{name}_attn", h, t, heads, context, bank, drop, g), h)
            if emit:
                out_banks.append(normed)
            if m["use_audio"] and audio is not None:
                h = self.run(lambda h: self.audio_attn(f"{p}.{name}_audio", h, audio, heads), h)
            if m["use_temporal"] and t > 1:
                h = self.run(lambda h: self.temporal(f"{p}.{name}_temporal", h, t, heads), h)
            return h

        chans = [m["base_channels"] * k for k in m["channel_multipliers"]]
        skips = [h]
        for level in range(len(chans)):
            for i in range(m["layers_per_block"]):
                h = res(f"down_{level}_res_{i}", h)
                if level in m["attention_levels"]:
                    h = stack(f"down_{level}_{i}", h)
                skips.append(h)
            if level < len(chans) - 1:
                h = self.conv(f"{p}.down_{level}_ds.Conv_0", h, stride=2, pads=[(1, 1), (1, 1)])
                skips.append(h)
        h = res("mid_res_0", h)
        h = stack("mid", h)
        h = res("mid_res_1", h)
        for level in reversed(range(len(chans))):
            for i in range(m["layers_per_block"] + 1):
                h = res(f"up_{level}_res_{i}", torch.cat([h, skips.pop()], dim=-1))
                if level in m["attention_levels"]:
                    h = stack(f"up_{level}_{i}", h)
            if level > 0:
                h = self.conv(f"{p}.up_{level}_us.Conv_0", _up2(h))
        h = self.conv(f"{p}.conv_out", self.group_norm(f"{p}.norm_out", h, g, True))
        out = h.reshape(b, t, *h.shape[1:])
        return (out[:, 0] if squeeze else out), out_banks

    def spatial(self, p: str, x: torch.Tensor, t: int, heads: int, context, bank, drop, groups: int):
        """x [(B T), H, W, C] -> (x + transformer, the block's LayerNormed tokens)."""
        n, hh, ww, c = x.shape
        tok = self.lin(f"{p}.proj_in", self.group_norm(f"{p}.norm", x, groups, False).reshape(n, hh * ww, c))
        blk = f"{p}.block_0"
        normed = self.layer_norm(f"{blk}.norm1", tok)
        extra = None if bank is None else bank.repeat_interleave(t, dim=0)
        tok = tok + self.mha(f"{blk}.attn1", normed, heads, extra=extra,
                             extra_drop=None if extra is None else drop)
        if f"{blk}.attn2.to_q.weight" in self.W and context is not None:
            tok = tok + self.mha(f"{blk}.attn2", self.layer_norm(f"{blk}.norm2", tok), heads,
                                 ctx=context.repeat_interleave(t, dim=0))
        tok = tok + self.geglu(f"{blk}.ff", self.layer_norm(f"{blk}.norm3", tok))
        return x + self.lin(f"{p}.proj_out", tok).reshape(n, hh, ww, c), normed

    def audio_attn(self, p: str, x: torch.Tensor, audio: torch.Tensor, heads: int) -> torch.Tensor:
        """x [(B T), H, W, C], audio [B, T, A, Da]: each frame's tokens attend to its window."""
        n, hh, ww, c = x.shape
        tok = self.layer_norm(f"{p}.norm", x.reshape(n, hh * ww, c))
        ctx = audio.float().reshape(n, audio.shape[2], audio.shape[3])
        return x + self.mha(f"{p}.attn", tok, heads, ctx=ctx).reshape(n, hh, ww, c)

    def temporal(self, p: str, x: torch.Tensor, t: int, heads: int) -> torch.Tensor:
        """Attention over the frames at every position: x [(B T), H, W, C]."""
        n, hh, ww, c = x.shape
        b, l = n // t, hh * ww
        pe = self.positions(t, c, x.device)
        tok = self.layer_norm(f"{p}.norm_in", x.reshape(b, t, l, c)) + pe[None, :, None, :]
        nt = self.layer_norm(f"{p}.norm_0", tok)
        frames = lambda y: y.transpose(1, 2).reshape(b * l, t, -1)  # [B, T, L, X] -> [(B L), T, X]
        a = p + ".attn_0"
        o = self.attend(frames(self.lin(f"{a}.to_q", nt)), frames(self.lin(f"{a}.to_k", nt)),
                        frames(self.lin(f"{a}.to_v", nt)), heads)
        o = o.reshape(b, l, t, -1).transpose(1, 2)
        tok = tok + self.lin(f"{a}.to_out", o)
        tok = tok + self.geglu(f"{p}.ff_0", self.layer_norm(f"{p}.norm_ff_0", tok))
        return x + self.lin(f"{p}.proj_out", tok).reshape(n, hh, ww, c)

    # -- the VAE --
    def _vae_res(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.resblock(name, x, None, self.cfg["vae"]["norm_groups"])

    def _vae_mid(self, p: str, h: torch.Tensor) -> torch.Tensor:
        g = self.cfg["vae"]["norm_groups"]
        h = self._vae_res(f"{p}.mid_res_0", h)
        n, hh, ww, c = h.shape
        a = self.group_norm(f"{p}.mid_attn.norm", h, g, False).reshape(n, hh * ww, c)
        h = h + self.mha(f"{p}.mid_attn.attn", a, 1).reshape(n, hh, ww, c)
        return self._vae_res(f"{p}.mid_res_1", h)

    def vae_moments(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [N, H, W, 3] -> (mean, std) of the posterior [N, h, w, 4]."""
        v, e = self.cfg["vae"], "vae.encoder"
        levels = len(v["channel_multipliers"])
        h = self.conv(f"{e}.conv_in", images.float())
        for level in range(levels):
            for i in range(v["num_res_blocks"]):
                h = self._vae_res(f"{e}.down_{level}_res_{i}", h)
            if level < levels - 1:
                h = self.conv(f"{e}.down_{level}_ds.Conv_0", h, stride=2)
        h = self._vae_mid(e, h)
        h = self.conv(f"{e}.conv_out", self.group_norm(f"{e}.norm_out", h, v["norm_groups"], True))
        mean, logvar = self.conv("vae.quant_conv", h).chunk(2, dim=-1)
        return mean, torch.exp(0.5 * logvar.clamp(-30.0, 20.0))

    def encode(self, images: torch.Tensor, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scaled latents of images [N, H, W, 3]: the posterior mean, or mean + std * eps."""
        mean, std = self.vae_moments(images)
        z = mean if eps is None else mean + std * eps.reshape(mean.shape).float()
        return z * self.cfg["vae"]["scaling_factor"]

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [N, h, w, 4] -> images [N, H, W, 3]."""
        v, d = self.cfg["vae"], "vae.decoder"
        h = self.conv("vae.post_quant_conv", latents.float() / v["scaling_factor"])
        h = self._vae_mid(d, self.conv(f"{d}.conv_in", h))
        for level in reversed(range(len(v["channel_multipliers"]))):
            for i in range(v["num_res_blocks"] + 1):
                h = self._vae_res(f"{d}.up_{level}_res_{i}", h)
            if level > 0:
                h = self.conv(f"{d}.up_{level}_us.Conv_0", _up2(h))
        return self.conv(f"{d}.conv_out", self.group_norm(f"{d}.norm_out", h, v["norm_groups"], True))

    # -- audio and text encoders --
    def audio_features(self, wav: torch.Tensor) -> torch.Tensor:
        """Waveform [B, S] -> features [B, Ta, D] (wav2vec2-base: conv stack, positional
        convolution, post-LN transformer)."""
        a, p = self.cfg["audio"], "audio_encoder"
        h = wav.float()[..., None]
        for i, (k, s) in enumerate(zip(a["conv_kernels"], a["conv_strides"])):
            h = self.conv(f"{p}.feature_extractor.conv{i}", h, stride=s, pads=[(0, 0)])
            if i == 0:  # a GroupNorm of one channel a group, over time
                h = self.group_norm(f"{p}.feature_extractor.gn0", h, h.shape[-1], False)
            h = F.gelu(h)
        h = self.lin(f"{p}.feat_proj", self.layer_norm(f"{p}.feat_norm", h))
        h = h + F.gelu(self.conv(f"{p}.pos_conv", h, pads=[(64, 64)], groups=16)[:, :-1])
        h = self.layer_norm(f"{p}.enc_norm", h)
        for i in range(a["num_layers"]):
            q = f"{p}.layer_{i}"
            h = self.layer_norm(f"{q}.norm1", h + self.mha(f"{q}.attn", h, a["num_heads"]))
            h = self.layer_norm(f"{q}.norm2", h + self.lin(f"{q}.ff2", F.gelu(self.lin(f"{q}.ff1", h))))
        return h

    def audio_windows(self, wav: torch.Tensor, num_frames: int, frame_offset: float = 0.0) -> torch.Tensor:
        """Per-video-frame windows [B, T, 2c+1, D]: frame f's holds the features nearest to the
        times of frames f-c .. f+c (round half to even), zero outside the clip."""
        a = self.cfg["audio"]
        feats = self.audio_features(wav)
        b, ta, d = feats.shape
        rate = a["sample_rate"] / math.prod(a["conv_strides"])
        c = a["context_frames"]
        frame = torch.arange(num_frames, dtype=torch.float32, device=wav.device) + frame_offset
        offs = torch.arange(-c, c + 1, dtype=torch.float32, device=wav.device)
        idx = torch.round((frame[:, None] + offs[None, :]) / a["video_fps"] * rate).to(torch.int64)
        valid = (idx >= 0) & (idx < ta)
        got = feats[:, idx.clamp(0, ta - 1).reshape(-1)].reshape(b, num_frames, 2 * c + 1, d)
        return torch.where(valid[None, :, :, None], got, torch.zeros((), device=wav.device))

    def text(self, ids: torch.Tensor) -> torch.Tensor:
        """CLIP token ids [B, L] -> hidden states [B, L, C]: causal pre-LN transformer, quick
        GELU, final LayerNorm."""
        c, p = self.cfg["clip"], "clip_text"
        if c["hidden_act"] != "quick_gelu":
            raise ValueError("the reference's text encoder takes quick_gelu")
        x = self.W[f"{p}.token_embedding.weight"][ids] + self.W[f"{p}.position_embedding"][None, : ids.shape[1]]
        l = ids.shape[1]
        heads, d = c["text_heads"], c["text_hidden_dim"] // c["text_heads"]
        mask = torch.ones((l, l), dtype=torch.bool, device=ids.device).tril()
        for i in range(c["text_layers"]):
            q = f"{p}.layer_{i}"
            y = self.layer_norm(f"{q}.norm1", x)
            split = lambda t: t.reshape(t.shape[0], l, heads, d).transpose(1, 2)
            qq, kk, vv = (split(self.lin(f"{q}.attn.{n}", y)) for n in ("to_q", "to_k", "to_v"))
            s = torch.matmul(self.q(qq), self.q(kk).transpose(-1, -2)) * (d ** -0.5)
            s = s.masked_fill(~mask, -1e9)
            o = torch.matmul(self.q(torch.softmax(s, dim=-1)), self.q(vv)).transpose(1, 2).reshape(x.shape)
            x = x + self.lin(f"{q}.attn.to_out", o)
            y = self.lin(f"{q}.fc1", self.layer_norm(f"{q}.norm2", x))
            x = x + self.lin(f"{q}.fc2", y * torch.sigmoid(1.702 * y))
        return self.layer_norm(f"{p}.final_norm", x)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of [N, H, W, C]."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
