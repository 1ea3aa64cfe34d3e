"""Seeded weights under the port's parameter names, made on the device in a few large calls.

One flat normal draw in the type the weights are served in, cut into the parameters in sorted
name order and scaled per parameter: kernels by 1/sqrt(fan-in) (lecun-normal), biases by
0.02, norm scales 1 + 0.1 z. No parameter starts at zero, so every branch the reference
writes (the zero-initialised temporal, audio and face-mask outputs among them) reaches the
output. The same seed gives the same values on the same device, which is how the reference
gets the program's weights back after the window without keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _scale_offset(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    if len(shape) == 1:
        return (0.1, 1.0) if name.endswith(".weight") else (0.02, 0.0)
    return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    views = list(flat.split(sizes))
    scale, offset = zip(*(_scale_offset(n, shapes[n]) for n in names))
    torch._foreach_mul_(views, list(scale))
    torch._foreach_add_(views, list(offset))
    return {n: v.view(shapes[n]) for n, v in zip(names, views)}
