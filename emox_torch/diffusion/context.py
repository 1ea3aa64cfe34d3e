"""Overlapping context-window scheduling for long-video denoising (the
port's copy of emox/diffusion/context.py, numpy only).

Per denoise step, overlapping windows of `context_size` frames are laid
out at power-of-2 temporal strides, with a bit-reversed per-step offset
(`ordered_halving`) so window seams rotate across steps; windows wrap
around the clip (closed loop). Per-window noise predictions are averaged
per frame by a hit counter. The windows of all steps are precomputed into
one int32 tensor, padded to the most windows of any step, with validity
weights.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


def ordered_halving(val: int, num_bits: int = 64) -> float:
    """Bit-reversed fraction in [0, 1): 0, 1/2, 1/4, 3/4, 1/8, 5/8, ..."""
    rev = 0
    v = val
    for _ in range(num_bits):
        rev = (rev << 1) | (v & 1)
        v >>= 1
    return rev / (1 << num_bits)


def uniform_windows(
    step: int,
    num_frames: int,
    context_size: int = 16,
    context_stride: int = 1,
    context_overlap: int = 4,
    closed_loop: bool = True,
) -> List[List[int]]:
    """Window index lists for one denoise step."""
    if num_frames <= context_size:
        return [list(range(num_frames))]
    windows: List[List[int]] = []
    max_stride_pow = int(np.ceil(np.log2(num_frames / context_size))) + 1
    for pow2 in range(min(context_stride, max_stride_pow)):
        stride = 1 << pow2
        pad = int(round(num_frames * ordered_halving(step)))
        start0 = int(round(stride * ordered_halving(step))) + pad
        stop = num_frames + pad + (0 if closed_loop else -context_overlap)
        hop = context_size * stride - context_overlap
        for j in range(start0, stop, hop):
            windows.append([e % num_frames for e in range(j, j + context_size * stride, stride)])
    return windows


class WindowPlan(NamedTuple):
    """Static gather/scatter plan for all denoise steps.

    indices: [num_steps, max_windows, context_size] int32 frame indices
    weights: [num_steps, max_windows] float32 — 1.0 for real windows,
             0.0 for padding rows (padding rows repeat window 0 so gathers
             stay in range but contribute nothing).
    """

    indices: np.ndarray
    weights: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.indices.shape[0]

    @property
    def max_windows(self) -> int:
        return self.indices.shape[1]

    @property
    def context_size(self) -> int:
        return self.indices.shape[2]


def window_plan(
    num_steps: int,
    num_frames: int,
    context_size: int = 16,
    context_stride: int = 1,
    context_overlap: int = 4,
    closed_loop: bool = True,
) -> WindowPlan:
    per_step = [
        uniform_windows(s, num_frames, context_size, context_stride, context_overlap, closed_loop)
        for s in range(num_steps)
    ]
    ctx = min(context_size, num_frames)
    max_w = max(len(ws) for ws in per_step)
    indices = np.zeros((num_steps, max_w, ctx), np.int32)
    weights = np.zeros((num_steps, max_w), np.float32)
    for s, ws in enumerate(per_step):
        for w, frames in enumerate(ws):
            indices[s, w] = frames
            weights[s, w] = 1.0
        for w in range(len(ws), max_w):
            indices[s, w] = indices[s, 0]
    # every frame must be covered by >= 1 window at every step
    for s in range(num_steps):
        covered = np.zeros(num_frames, bool)
        covered[indices[s][weights[s] > 0].reshape(-1)] = True
        if not covered.all():
            raise AssertionError(f"step {s}: frames {np.where(~covered)[0]} uncovered")
    return WindowPlan(indices=indices, weights=weights)
