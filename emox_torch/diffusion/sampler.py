"""DDIM sampling loop and classifier-free guidance
(counterpart of emox/diffusion/sampler.py).

The windowed sampler and DDIM inversion wait for a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from emox_torch.diffusion.schedule import Schedule, ddim_step, inference_timesteps


def ddim_sample(denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], latents: torch.Tensor,
                sched: Schedule, num_steps: int, eta: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """denoise_fn(latents, t[B]) -> model_out. Returns the final latents."""
    ts = inference_timesteps(sched.num_train_timesteps, num_steps).tolist()
    b = latents.shape[0]
    dev = latents.device
    for t, t_prev in zip(ts, ts[1:] + [-1]):
        tb = torch.full((b,), t, dtype=torch.int64, device=dev)
        out = denoise_fn(latents, tb)
        latents = ddim_step(sched, out, latents, tb, torch.full((b,), t_prev, dtype=torch.int64, device=dev),
                            eta=eta, generator=generator)
    return latents


def cfg_combine(uncond: torch.Tensor, cond: torch.Tensor, scale: float) -> torch.Tensor:
    """Classifier-free guidance."""
    return uncond + scale * (cond - uncond)
