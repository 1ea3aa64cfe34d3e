"""Latent frame interpolation (counterpart of emox/diffusion/interp.py):
upsample the frame rate post hoc by interpolating between adjacent latent
frames."""

from __future__ import annotations

import torch


def lerp_latents(a: torch.Tensor, b: torch.Tensor, t: float) -> torch.Tensor:
    return (1.0 - t) * a + t * b


def slerp_latents(a: torch.Tensor, b: torch.Tensor, t: float, dot_threshold: float = 0.9995) -> torch.Tensor:
    """Spherical interpolation on the flattened latents (the whole batch as
    one vector); lerp where they are nearly parallel."""
    af = a.reshape(-1).float()
    bf = b.reshape(-1).float()
    dot = (af * bf).sum() / (torch.linalg.vector_norm(af) * torch.linalg.vector_norm(bf) + 1e-12)
    omega = torch.arccos(dot.clamp(-1.0, 1.0))
    so = torch.sin(omega)
    slerped = (torch.sin((1.0 - t) * omega) / so) * af + (torch.sin(t * omega) / so) * bf
    lerped = (1.0 - t) * af + t * bf
    out = torch.where(dot.abs() > dot_threshold, lerped, slerped)
    return out.reshape(a.shape).to(a.dtype)


def interpolate_latents(latents: torch.Tensor, factor: int, mode: str = "slerp") -> torch.Tensor:
    """[B, T, ...] -> [B, (T-1)*factor + 1, ...], inserting factor-1
    interpolated frames between each adjacent pair."""
    if factor <= 1:
        return latents
    fn = slerp_latents if mode == "slerp" else lerp_latents
    frames = [latents[:, 0]]
    for i in range(latents.shape[1] - 1):
        for j in range(1, factor):
            frames.append(fn(latents[:, i], latents[:, i + 1], j / factor))
        frames.append(latents[:, i + 1])
    return torch.stack(frames, dim=1)
