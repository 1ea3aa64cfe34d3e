"""The CLIP text and vision encoders (counterpart of emox/models/clip.py).

transformers' CLIPTextModel and CLIPVisionModelWithProjection compute (the
openai/clip-vit-large-patch14 layout SD-1.5 ships):

  * text: token + position embeddings, a causal pre-LN transformer with
    biased q/k/v/out projections, a final LayerNorm. It gives the per-token
    hidden states the denoiser's text cross-attention (`attn2`) reads.
  * vision: a bias-free patch convolution, the class token and position
    embeddings, a pre-LayerNorm, the same transformer without the mask, a
    post-LayerNorm on the class token and a bias-free projection. It gives
    the identity embedding the denoiser adds to its time embedding
    (model.use_identity_embed).

The sequences are 77 tokens and 257 patches, so attention is plain PyTorch,
as the reference leaves it to XLA: scores in fp32 (masked scores -1e9 in
the text encoder), softmax in fp32, P rounded to v's type for P v.

Attribute names are the flax submodule names, so the weight bridge is a
rename plus a transpose. Images are channels-last [B, H, W, 3].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.comm.sharding import attend_heads
from emox_torch.core.config import CLIPConfig
from emox_torch.nn.layers import Conv, Dense, LayerNorm

_NEG_INF = -1e9  # the reference's masked score


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"unknown CLIP activation {name!r}")


class Embed(nn.Module):
    """flax nn.Embed counterpart: `weight` [num, features] (flax `embedding`)."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features))
        self.normal_init = {"weight": features ** -0.5}  # flax's default embed init

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class CLIPAttention(nn.Module):
    """Multi-head self-attention with an optional causal mask (biased q, k,
    v and out projections, transformers CLIPAttention)."""

    # under tensor parallelism where the heads do not divide: the model axis
    # (emox_torch.comm.sharding.ModelShard) that q, k and v are gathered over
    tp_gather = None

    def __init__(self, dim: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.causal = causal
        self.to_q, self.to_k, self.to_v, self.to_out = (Dense(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, C]
        b, l, _ = x.shape
        hd = self.head_dim

        def attend(q, k, v):
            split = lambda y: y.reshape(b, l, -1, hd).transpose(1, 2)
            q = split(q) * (hd ** -0.5)
            k = split(k)
            v = split(v)
            s = torch.matmul(q.float(), k.float().transpose(-1, -2))
            if self.causal:
                mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
                s = s.masked_fill(~mask, _NEG_INF)
            p = torch.softmax(s, dim=-1).to(v.dtype)
            return torch.matmul(p, v).transpose(1, 2).reshape(b, l, q.shape[1] * hd)

        return self.to_out(attend_heads(self.tp_gather, attend, self.to_q(x), self.to_k(x), self.to_v(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, causal: bool, hidden_act: str):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = CLIPAttention(dim, heads, causal=causal)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Dense(dim, 4 * dim)
        self.fc2 = Dense(4 * dim, dim)
        self.act = _act(hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(self.act(self.fc1(self.norm2(x))))


class CLIPTextEncoder(nn.Module):
    """transformers CLIPTextModel: token + position embeddings -> causal
    transformer -> final LayerNorm. ids [B, L] -> hidden states [B, L, C]."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        c = cfg.text_hidden_dim
        self.token_embedding = Embed(cfg.vocab_size, c)
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_positions, c))
        self.normal_init = {"position_embedding": 0.01}
        self.layers = cfg.text_layers
        for i in range(cfg.text_layers):
            setattr(self, f"layer_{i}", CLIPEncoderLayer(c, cfg.text_heads, True, cfg.hidden_act))
        self.final_norm = LayerNorm(c)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tok = self.token_embedding(input_ids)
        x = tok + self.position_embedding[None, : input_ids.shape[1]].to(tok.dtype)
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.final_norm(x)

    def pooled(self, input_ids: torch.Tensor, eos_token_id: int = 49407) -> torch.Tensor:
        """EOS-token pooled embedding (transformers pooled_output)."""
        hidden = self(input_ids)
        idx = torch.argmax((input_ids == eos_token_id).int(), dim=1)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


class CLIPVisionEncoder(nn.Module):
    """transformers CLIPVisionModelWithProjection: patch conv (no bias) +
    class token + position embeddings -> pre-LN -> transformer -> post-LN on
    the class token -> linear projection (no bias)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        c = cfg.vision_hidden_dim
        self.hidden = c
        self.patch_embedding = Conv(3, c, (cfg.patch_size, cfg.patch_size), stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c))
        self.position_embedding = nn.Parameter(torch.empty(1 + (cfg.image_size // cfg.patch_size) ** 2, c))
        self.normal_init = {"class_embedding": 0.02, "position_embedding": 0.01}
        self.pre_norm = LayerNorm(c)
        self.layers = cfg.vision_layers
        for i in range(cfg.vision_layers):
            setattr(self, f"layer_{i}", CLIPEncoderLayer(c, cfg.vision_heads, False, cfg.hidden_act))
        self.post_norm = LayerNorm(c)
        self.visual_projection = Dense(c, cfg.projection_dim, bias=False)

    def forward(self, images: torch.Tensor, project: bool = True) -> torch.Tensor:
        """images [B, H, W, 3] (CLIP-normalised) -> [B, proj] (project=True)
        or the hidden states [B, 1+P, C]."""
        b = images.shape[0]
        p = self.patch_embedding(images).reshape(b, -1, self.hidden)
        cls = self.class_embedding.to(p.dtype).expand(b, 1, self.hidden)
        x = torch.cat([cls, p], dim=1)
        x = self.pre_norm(x + self.position_embedding[None, : x.shape[1]].to(x.dtype))
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x)
        if not project:
            return x
        return self.visual_projection(self.post_norm(x[:, 0]))


# openai CLIP image preprocessing constants (transformers CLIPImageProcessor)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(images_01: torch.Tensor) -> torch.Tensor:
    """[0,1]-ranged [B, H, W, 3] -> CLIP-normalised."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=images_01.dtype, device=images_01.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=images_01.dtype, device=images_01.device)
    return (images_01 - mean) / std
