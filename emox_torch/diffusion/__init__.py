"""Diffusion: schedule, DDIM/DDPM steps, samplers (short, windowed,
inversion), the context-window plan, latent interpolation and the
training-loss helpers."""

from emox_torch.diffusion.context import WindowPlan, ordered_halving, uniform_windows, window_plan
from emox_torch.diffusion.interp import interpolate_latents, lerp_latents, slerp_latents
from emox_torch.diffusion.sampler import (
    cfg_combine,
    ddim_invert,
    ddim_sample,
    windowed_ddim_sample,
    windowed_model_out,
)
from emox_torch.diffusion.schedule import (
    Schedule,
    add_noise,
    ddim_step,
    ddpm_step,
    get_velocity,
    inference_timesteps,
    make_schedule,
    min_snr_loss_weight,
    pred_to_x0,
    snr,
)

__all__ = [
    "Schedule",
    "WindowPlan",
    "add_noise",
    "cfg_combine",
    "ddim_invert",
    "ddim_sample",
    "ddim_step",
    "ddpm_step",
    "get_velocity",
    "inference_timesteps",
    "interpolate_latents",
    "lerp_latents",
    "make_schedule",
    "min_snr_loss_weight",
    "ordered_halving",
    "pred_to_x0",
    "slerp_latents",
    "snr",
    "uniform_windows",
    "window_plan",
    "windowed_ddim_sample",
    "windowed_model_out",
]
