"""Diffusion: schedule, DDIM step, sampler and the training-loss helpers."""

from emox_torch.diffusion.sampler import cfg_combine, ddim_sample
from emox_torch.diffusion.schedule import (
    Schedule,
    add_noise,
    ddim_step,
    get_velocity,
    inference_timesteps,
    make_schedule,
    min_snr_loss_weight,
    pred_to_x0,
    snr,
)

__all__ = [
    "Schedule",
    "add_noise",
    "cfg_combine",
    "ddim_sample",
    "ddim_step",
    "get_velocity",
    "inference_timesteps",
    "make_schedule",
    "min_snr_loss_weight",
    "pred_to_x0",
    "snr",
]
