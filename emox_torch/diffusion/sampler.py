"""DDIM sampling loops, DDIM inversion and classifier-free guidance
(counterpart of emox/diffusion/sampler.py).

  * ddim_sample: one loop over the timesteps (short clips, single frames).
  * windowed_ddim_sample: long-video denoising. Per step the overlapping
    frame windows of a WindowPlan are gathered, denoised, scatter-added
    back with `index_add_` and divided by each frame's hit count
    (`windowed_model_out`, which the serving pipeline shares).
  * ddim_invert: clean latents -> noise latents along the model's own
    trajectory.

CFG is composed by the caller inside the denoise function: the samplers
stay agnostic to conditioning.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from emox_torch.diffusion.context import WindowPlan
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


WindowFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def windowed_sum(denoise_window_fn: WindowFn, latents: torch.Tensor, t: torch.Tensor, indices: np.ndarray,
                 weights: np.ndarray, rank: int = 0, n_ranks: int = 1):
    """(noise_sum, counts) of one step's windows: the outputs of the real
    windows rank::n_ranks (weight > 0) scatter-added per frame, and every
    real window's hits per frame, at least 1e-6 ([T]). A padding row adds
    weight 0 to its frames and 0 to their counts, so leaving it out changes
    nothing. denoise_window_fn(window_latents [W', B, c, h, w, C], t [B],
    frame_idx [W', c] int64) -> model outputs of the same shape; frame_idx
    lets the caller gather per-frame conditioning (audio, speeds)."""
    real = weights > 0
    indices, weights = indices[real], weights[real]
    dev = latents.device
    b, n = latents.shape[:2]
    noise_sum = torch.zeros_like(latents)
    mine = slice(rank, None, n_ranks)
    if len(indices[mine]):
        idx = torch.from_numpy(indices[mine].astype(np.int64)).to(dev)
        windows = latents[:, idx].transpose(0, 1)  # [W', B, c, h, w, C]
        preds = denoise_window_fn(windows, t, idx).to(latents.dtype)
        preds = preds * torch.from_numpy(weights[mine]).to(dev, latents.dtype).reshape(-1, *(1,) * (preds.dim() - 1))
        flat = preds.transpose(0, 1).reshape(b, idx.numel(), *latents.shape[2:])
        noise_sum.index_add_(1, idx.reshape(-1), flat)
    counts = np.zeros(n, np.float32)
    np.add.at(counts, indices.reshape(-1), np.repeat(weights, indices.shape[1]))
    return noise_sum, torch.from_numpy(np.maximum(counts, np.float32(1e-6))).to(dev)


def windowed_model_out(denoise_window_fn: WindowFn, latents: torch.Tensor, t: torch.Tensor,
                       indices: np.ndarray, weights: np.ndarray, shard=(0, 1, None)) -> torch.Tensor:
    """One step's model output over overlapping windows: indices [W, c] and
    weights [W] are one step of a WindowPlan, the outputs scatter-added per
    frame and divided by the frame's hit count (windowed_sum). shard (rank,
    n, group): this rank denoises the real windows rank::n, and one
    all-reduce (SUM) over the group completes the sums."""
    rank, n_ranks, group = shard
    noise_sum, counts = windowed_sum(denoise_window_fn, latents, t, indices, weights, rank, n_ranks)
    if n_ranks > 1:
        from emox_torch.comm.runtime import all_reduce_

        all_reduce_(noise_sum, group)
    return noise_sum / counts.reshape(1, -1, *(1,) * (latents.dim() - 2))


def windowed_ddim_sample(denoise_window_fn: WindowFn, latents: torch.Tensor, sched: Schedule, plan: WindowPlan,
                         eta: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DDIM over a long frame axis [B, T, h, w, C]: each step averages the
    windows of plan's step (windowed_model_out). eta > 0 draws its noise
    from `generator`."""
    ts = inference_timesteps(sched.num_train_timesteps, plan.num_steps).tolist()
    b = latents.shape[0]
    dev = latents.device
    for i, (t, t_prev) in enumerate(zip(ts, ts[1:] + [-1])):
        tb = torch.full((b,), t, dtype=torch.int64, device=dev)
        out = windowed_model_out(denoise_window_fn, latents, tb, plan.indices[i], plan.weights[i])
        latents = ddim_step(sched, out, latents, tb, torch.full((b,), t_prev, dtype=torch.int64, device=dev),
                            eta=eta, generator=generator)
    return latents


def cfg_combine(uncond: torch.Tensor, cond: torch.Tensor, scale: float) -> torch.Tensor:
    """Classifier-free guidance."""
    return uncond + scale * (cond - uncond)


def ddim_invert(denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], latents: torch.Tensor,
                sched: Schedule, num_steps: int) -> torch.Tensor:
    """Deterministic DDIM inversion: clean latents -> noise latents along the
    model's own trajectory. Over the ascending timesteps t_0 < ... < t_{S-1}
    it makes the S-1 updates t_i -> t_{i+1}, each re-projecting the (x0, eps)
    estimate at t_i onto the noise level t_{i+1}: the algebraic reverse of
    the sampler's `ddim_step` pairs. The initial x0 -> t_0 projection is
    absorbed into the first update (alpha_bar[t_0] ~ 1)."""
    ts = inference_timesteps(sched.num_train_timesteps, num_steps).flip(0).tolist()
    b = latents.shape[0]
    dev = latents.device
    for t, t_next in zip(ts[:-1], ts[1:]):
        tb = torch.full((b,), t, dtype=torch.int64, device=dev)
        out = denoise_fn(latents, tb)
        latents = ddim_step(sched, out, latents, tb, torch.full((b,), t_next, dtype=torch.int64, device=dev))
    return latents
