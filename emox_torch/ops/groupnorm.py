"""GroupNorm(+SiLU) for the port, as plain PyTorch.

Counterpart of emox/ops/groupnorm.py's default path, `group_norm_xla`.
The reference's two Pallas GroupNorm kernels (`_gn_kernel`,
`_gn_stats_kernel`) are off by default there and wait for a later slice
of the port (ROADMAP.md, Queue 2, K8).

Rounding follows the reference, not torch's F.group_norm: statistics
accumulate in fp32, the map is applied as one `x * a + b` in x's own type
with per-channel coefficients folded in fp32.
"""

from __future__ import annotations

import torch


def group_norm_xla(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                   eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """x [..., L, C] normalised over (L, C // groups) per group."""
    *lead, l, c = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    cg = c // groups
    xg = x.reshape(*lead, l, groups, cg).float()
    mean = xg.mean(dim=(-3, -1), keepdim=True)  # [..., 1, G, 1]
    var = xg.square().mean(dim=(-3, -1), keepdim=True) - mean.square()
    inv = torch.rsqrt(var + eps)
    ones = [1] * len(lead)
    gamma_g = gamma.float().reshape(*ones, 1, groups, cg)
    beta_g = beta.float().reshape(*ones, 1, groups, cg)
    a = (gamma_g * inv).reshape(*lead, 1, c)
    b = (beta_g - mean * gamma_g * inv).reshape(*lead, 1, c)
    xn = x * a.to(x.dtype) + b.to(x.dtype)
    if silu:
        xn = xn * torch.sigmoid(xn)
    return xn
