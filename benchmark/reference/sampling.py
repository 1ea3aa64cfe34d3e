"""Plain float32 sampling and training arithmetic: the DDIM schedule and step, classifier-free
guidance, the overlapping window plan of a long clip, and AdamW.

The window plan is a frozen copy of the plan emox_torch/diffusion/context.py lays out (the
layout of AnimateDiff's uniform context scheduler: windows of `context` frames at a hop of
context - overlap, rotated each step by a bit-reversed offset, wrapping around the clip), so
that a later change to the program cannot move what the benchmark expects of it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


# ---- schedule and step ------------------------------------------------------------------------
def alphas_cumprod(diffusion: dict) -> torch.Tensor:
    """The float32 cumulative product of 1 - beta over the training steps (scaled_linear
    betas, as SD-1.5 trains them), on the CPU."""
    if diffusion["beta_schedule"] != "scaled_linear" or diffusion.get("zero_terminal_snr"):
        raise ValueError("the reference takes the scaled_linear schedule")
    n = diffusion["num_train_timesteps"]
    betas = torch.linspace(diffusion["beta_start"] ** 0.5, diffusion["beta_end"] ** 0.5, n, dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def timesteps(num_train: int, steps: int) -> List[int]:
    """Descending timesteps with "leading" spacing (diffusers' DDIM default)."""
    step = num_train // steps
    return [i * step for i in reversed(range(steps))]


def ddim_step(acp: torch.Tensor, eps: torch.Tensor, x: torch.Tensor, t: int, t_prev: int) -> torch.Tensor:
    """One deterministic DDIM update of x at t to t_prev (t_prev < 0: the last step)."""
    a_t = float(acp[t])
    a_prev = float(acp[t_prev]) if t_prev >= 0 else 1.0
    x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
    return math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps


def add_noise(acp: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    a = acp.to(x0.device)[t].reshape(-1, *(1,) * (x0.dim() - 1))
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def cfg_combine(uncond: torch.Tensor, cond: torch.Tensor, scale: float) -> torch.Tensor:
    return uncond + scale * (cond - uncond)


# ---- the window plan (frozen copy) --------------------------------------------------------------
def _ordered_halving(val: int, bits: int = 64) -> float:
    rev = 0
    for _ in range(bits):
        rev = (rev << 1) | (val & 1)
        val >>= 1
    return rev / (1 << bits)


def windows(step: int, num_frames: int, context: int, stride: int, overlap: int) -> List[List[int]]:
    """The frame indices of each window of one denoise step."""
    if num_frames <= context:
        return [list(range(num_frames))]
    out: List[List[int]] = []
    max_pow = int(np.ceil(np.log2(num_frames / context))) + 1
    for pow2 in range(min(stride, max_pow)):
        s = 1 << pow2
        pad = int(round(num_frames * _ordered_halving(step)))
        start = int(round(s * _ordered_halving(step))) + pad
        for j in range(start, num_frames + pad, context * s - overlap):
            out.append([e % num_frames for e in range(j, j + context * s, s)])
    return out


# ---- AdamW ------------------------------------------------------------------------------------
class AdamW:
    """torch.optim.AdamW's update written out (decoupled weight decay, bias-corrected
    moments), after clipping the gradients by their global norm."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, clip: float):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.wd, self.clip = lr, b1, b2, eps, weight_decay, clip
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Applies one update; returns the clipped gradients the moments took."""
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
        scale = self.clip / norm if norm >= self.clip else 1.0
        grads = [g * scale for g in grads]
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m / c1, (v / c2).sqrt().add_(self.eps), value=-self.lr)
        return grads


def leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves: Sequence[str]) -> Tuple[float, str]:
    """The worst leaf's |got - want| / max(want, the median leaf's want), and its name."""
    med = float(np.median([want[n] for n in leaves])) if leaves else 0.0
    worst, name = 0.0, ""
    for n in leaves:
        gap = abs(got[n] - want[n]) / max(want[n], med, 1e-30)
        if gap > worst or not name:
            worst, name = gap, n
    return worst, name
