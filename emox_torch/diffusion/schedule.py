"""Noise schedule + DDIM step as functions on tensors
(counterpart of emox/diffusion/schedule.py).

1000 training steps, scaled_linear betas 0.00085 -> 0.012 by default. The
tables are built in float32, as the reference builds them (its float64
request falls back to float32 without JAX's x64 mode) and as diffusers
does. Training adds velocity targets and min-SNR weighting; `ddpm_step`
is the ancestral update.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from emox_torch.core.config import DiffusionConfig


class Schedule(NamedTuple):
    betas: torch.Tensor  # [T] float32
    alphas_cumprod: torch.Tensor  # [T] float32
    num_train_timesteps: int
    prediction_type: str


def _betas(cfg: DiffusionConfig) -> torch.Tensor:
    t = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return torch.linspace(cfg.beta_start, cfg.beta_end, t, dtype=torch.float32)
    if cfg.beta_schedule == "scaled_linear":
        return torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, t, dtype=torch.float32) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        s = torch.arange(t + 1, dtype=torch.float32) / t
        f = torch.cos((s + 0.008) / 1.008 * torch.pi / 2) ** 2
        return torch.clamp(1.0 - f[1:] / f[:-1], 0.0, 0.999)
    raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")


def _rescale_zero_terminal_snr(acp: torch.Tensor) -> torch.Tensor:
    """Shift/scale sqrt(alpha_bar) so the final step has zero SNR (arXiv:2305.08891)."""
    s = torch.sqrt(acp)
    s0, st = s[0].clone(), s[-1].clone()
    s = (s - st) * (s0 / (s0 - st))
    return s ** 2


def make_schedule(cfg: DiffusionConfig, device: Optional[torch.device] = None) -> Schedule:
    betas = _betas(cfg)
    acp = torch.cumprod(1.0 - betas, dim=0)
    if cfg.zero_terminal_snr:
        acp = _rescale_zero_terminal_snr(acp)
        betas = 1.0 - acp / torch.cat([torch.ones(1), acp[:-1]])
    return Schedule(betas.to(device), acp.to(device), cfg.num_train_timesteps, cfg.prediction_type)


def _gather(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] broadcast to an ndim-shaped batch factor."""
    out = table[t.to(table.device)]
    return out.reshape(out.shape + (1,) * (ndim - out.dim()))


def add_noise(sched: Schedule, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    acp = _gather(sched.alphas_cumprod, t, x0.dim())
    return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise


def get_velocity(sched: Schedule, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The v-prediction target sqrt(acp) noise - sqrt(1 - acp) x0."""
    acp = _gather(sched.alphas_cumprod, t, x0.dim())
    return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * x0


def snr(sched: Schedule, t: torch.Tensor) -> torch.Tensor:
    acp = sched.alphas_cumprod[t.to(sched.alphas_cumprod.device)]
    return acp / (1.0 - acp)


def min_snr_loss_weight(sched: Schedule, t: torch.Tensor, gamma: float) -> torch.Tensor:
    """Min-SNR-gamma per-sample loss weights (arXiv:2303.09556); gamma <= 0
    gives ones."""
    if gamma <= 0:
        return torch.ones(t.shape, dtype=torch.float32, device=t.device)
    s = snr(sched, t)
    if sched.prediction_type == "v_prediction":
        return torch.clamp(s, max=gamma) / (s + 1.0)
    return torch.clamp(s, max=gamma) / torch.clamp(s, min=1e-8)


def pred_to_x0(sched: Schedule, model_out: torch.Tensor, sample: torch.Tensor,
               t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convert model output to (x0, epsilon) under the prediction type."""
    acp = _gather(sched.alphas_cumprod, t, sample.dim())
    sqrt_acp, sqrt_1macp = torch.sqrt(acp), torch.sqrt(1.0 - acp)
    if sched.prediction_type == "epsilon":
        eps = model_out
        x0 = (sample - sqrt_1macp * eps) / sqrt_acp
    elif sched.prediction_type == "v_prediction":
        x0 = sqrt_acp * sample - sqrt_1macp * model_out
        eps = sqrt_acp * model_out + sqrt_1macp * sample
    else:
        raise ValueError(f"unknown prediction type {sched.prediction_type!r}")
    return x0, eps


def inference_timesteps(num_train_timesteps: int, num_inference_steps: int) -> torch.Tensor:
    """Descending int64 timestep sequence with 'leading' spacing (diffusers
    DDIM default)."""
    step = num_train_timesteps // num_inference_steps
    return (torch.arange(num_inference_steps) * step).flip(0)


def ddim_step(sched: Schedule, model_out: torch.Tensor, sample: torch.Tensor, t: torch.Tensor,
              t_prev: torch.Tensor, eta: float = 0.0, generator: Optional[torch.Generator] = None,
              clip_x0: bool = False) -> torch.Tensor:
    """One DDIM update from t to t_prev (t_prev < 0 means the final step).
    eta > 0 draws its noise from `generator`."""
    x0, eps = pred_to_x0(sched, model_out, sample, t)
    if clip_x0:
        x0 = x0.clamp(-1.0, 1.0)
    acp = sched.alphas_cumprod
    t_prev = t_prev.to(acp.device)
    acp_prev = torch.where(t_prev >= 0, acp[t_prev.clamp_min(0)], torch.ones((), device=acp.device))
    acp_prev = acp_prev.reshape(acp_prev.shape + (1,) * (sample.dim() - acp_prev.dim()))
    acp_t = _gather(acp, t, sample.dim())
    if eta > 0:
        var = (1 - acp_prev) / (1 - acp_t) * (1 - acp_t / acp_prev)
        sigma = eta * torch.sqrt(var.clamp_min(0.0))
    else:
        sigma = torch.zeros((), device=acp.device)
    dir_xt = torch.sqrt((1.0 - acp_prev - sigma.square()).clamp_min(0.0)) * eps
    prev = torch.sqrt(acp_prev) * x0 + dir_xt
    if eta > 0:
        if generator is None:
            raise ValueError("eta > 0 requires a torch.Generator")
        noise = torch.randn(sample.shape, generator=generator, device=sample.device, dtype=torch.float32)
        prev = prev + sigma * noise.to(sample.dtype)
    return prev


def ddpm_step(sched: Schedule, model_out: torch.Tensor, sample: torch.Tensor, t: torch.Tensor,
              generator: Optional[torch.Generator] = None, clip_x0: bool = True,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ancestral DDPM update from t to t-1 (Ho et al. 2020, eq. 7). The
    noise is `noise` when given, else drawn from `generator`; rows at t = 0
    add none."""
    x0, _ = pred_to_x0(sched, model_out, sample, t)
    if clip_x0:
        x0 = x0.clamp(-1.0, 1.0)
    acp = sched.alphas_cumprod
    t = t.to(acp.device)
    acp_t = _gather(acp, t, sample.dim())
    acp_prev = torch.where(t > 0, acp[(t - 1).clamp_min(0)], torch.ones((), device=acp.device))
    acp_prev = acp_prev.reshape(acp_prev.shape + (1,) * (sample.dim() - acp_prev.dim()))
    beta_t = _gather(sched.betas, t, sample.dim())
    alpha_t = 1.0 - beta_t
    coef_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
    coef_xt = torch.sqrt(alpha_t) * (1.0 - acp_prev) / (1.0 - acp_t)
    mean = coef_x0 * x0 + coef_xt * sample
    var = ((1.0 - acp_prev) / (1.0 - acp_t) * beta_t).clamp_min(1e-20)
    if noise is None:
        if generator is None:
            raise ValueError("ddpm_step needs a torch.Generator or noise=")
        noise = torch.randn(sample.shape, generator=generator, device=sample.device, dtype=torch.float32)
    t_b = t.reshape(t.shape + (1,) * (sample.dim() - t.dim()))
    return mean + torch.where(t_b > 0, torch.sqrt(var) * noise.to(sample.dtype), torch.zeros((), device=acp.device))
