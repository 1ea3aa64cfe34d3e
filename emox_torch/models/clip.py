"""The CLIP text encoder (counterpart of emox/models/clip.py).

transformers' CLIPTextModel compute (the openai/clip-vit-large-patch14
layout SD-1.5 ships): token + position embeddings, a causal pre-LN
transformer with biased q/k/v/out projections, a final LayerNorm. It gives
the per-token hidden states the denoiser's text cross-attention (`attn2`)
reads. The sequences are 77 tokens, so attention is plain PyTorch with the
causal mask, as the reference leaves it to XLA: scores in fp32, masked
scores -1e9, softmax in fp32, P rounded to v's type for P v.

Attribute names are the flax submodule names, so the weight bridge is a
rename plus a transpose. `CLIPVisionEncoder` and `clip_normalize` wait with
the identity embedding (ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.core.config import CLIPConfig
from emox_torch.nn.layers import Dense, LayerNorm

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

    def __init__(self, dim: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.to_q, self.to_k, self.to_v, self.to_out = (Dense(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, C]
        b, l, c = x.shape
        hd = c // self.heads
        split = lambda y: y.reshape(b, l, self.heads, hd).transpose(1, 2)
        q = split(self.to_q(x)) * (hd ** -0.5)
        k = split(self.to_k(x))
        v = split(self.to_v(x))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if self.causal:
            mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
            s = s.masked_fill(~mask, _NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b, l, c)
        return self.to_out(o)


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
