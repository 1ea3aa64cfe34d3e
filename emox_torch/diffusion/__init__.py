"""Diffusion: schedule, DDIM step and sampler."""

from emox_torch.diffusion.sampler import cfg_combine, ddim_sample
from emox_torch.diffusion.schedule import (
    Schedule,
    add_noise,
    ddim_step,
    inference_timesteps,
    make_schedule,
    pred_to_x0,
)

__all__ = [
    "Schedule",
    "add_noise",
    "cfg_combine",
    "ddim_sample",
    "ddim_step",
    "inference_timesteps",
    "make_schedule",
    "pred_to_x0",
]
