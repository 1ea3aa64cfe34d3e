"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller names another device.
With no card and no explicit request they raise: a silent fall back to the
CPU would hand a user a program hundreds of times slower than the one they
asked for, and would let a measurement on the wrong device pass for one
taken on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA card.

    Raises RuntimeError when device is None and CUDA is unavailable."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "emox_torch runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
