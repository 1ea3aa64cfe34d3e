"""Timestep + positional embeddings (counterpart of emox/nn/embeddings.py).

Sinusoidal timestep embedding with the SD convention (flip_sin_to_cos,
max period 10000) and the temporal positional table of the motion modules.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.nn.layers import Dense


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True) -> torch.Tensor:
    """Sinusoidal embedding of integer timesteps -> [B, dim] (fp32)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def sinusoidal_positions(max_len: int, dim: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """[max_len, dim] sin/cos table (sin at even, cos at odd columns)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros(max_len, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)[:, : dim // 2]
    return pe


class TimestepEmbedder(nn.Module):
    """sinusoidal -> Dense -> SiLU -> Dense."""

    def __init__(self, dim: int, sinusoidal_dim: int):
        super().__init__()
        self.sinusoidal_dim = sinusoidal_dim
        self.fc1 = Dense(sinusoidal_dim, dim)
        self.fc2 = Dense(dim, dim)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(timesteps, self.sinusoidal_dim)
        return self.fc2(F.silu(self.fc1(emb)))
