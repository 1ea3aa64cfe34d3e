"""Paired data augmentation with shared randomness (the port's copy of
emox/data/augment.py).

Each clip gets one sampled AugmentParams, applied identically to every
frame and to its masks, landmarks and control renders. The draws from the
np.random.Generator are the reference's, in the same order, so one seed
gives the same crop, flip and colour on both packages.

Numpy only; runs in the host loader threads, never on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from emox_torch.core.config import AugmentConfig
from emox_torch.data import native

__all__ = ["AugmentConfig", "AugmentParams", "sample_params", "apply_geometry", "apply_color", "augment_frame",
           "apply_geometry_points", "augment_clip"]


@dataclass(frozen=True)
class AugmentParams:
    flip: bool
    y0: int
    x0: int
    crop_h: int
    crop_w: int
    brightness: float
    contrast: float


def sample_params(cfg: AugmentConfig, rng: np.random.Generator, height: int, width: int) -> AugmentParams:
    scale = rng.uniform(cfg.crop_scale_min, cfg.crop_scale_max)
    ch = max(1, int(round(height * np.sqrt(scale))))
    cw = max(1, int(round(width * np.sqrt(scale))))
    return AugmentParams(
        flip=bool(rng.random() < cfg.horizontal_flip),
        y0=int(rng.integers(0, height - ch + 1)),
        x0=int(rng.integers(0, width - cw + 1)),
        crop_h=ch,
        crop_w=cw,
        brightness=float(rng.uniform(-cfg.brightness, cfg.brightness)),
        contrast=float(rng.uniform(1 - cfg.contrast, 1 + cfg.contrast)),
    )


def apply_geometry(img: np.ndarray, p: AugmentParams, out_h: int, out_w: int) -> np.ndarray:
    """Crop/flip/resize [H, W, C] (frames AND masks: geometry only)."""
    out = img[p.y0: p.y0 + p.crop_h, p.x0: p.x0 + p.crop_w]
    if p.flip:
        out = out[:, ::-1]
    if out.shape[:2] != (out_h, out_w):
        out = native.resize_bilinear(np.ascontiguousarray(out, np.float32), out_h, out_w)
    return out


def apply_color(img: np.ndarray, p: AugmentParams, pivot: Optional[float] = None) -> np.ndarray:
    """Brightness/contrast on [-1, 1] frames (NOT masks). Contrast pivots on
    `pivot` (the pre-resize crop mean, as augment_frame uses) or the image's
    own mean."""
    m = img.mean() if pivot is None else pivot
    out = (img - m) * p.contrast + m + p.brightness
    return np.clip(out, -1.0, 1.0).astype(np.float32)


def augment_frame(frame: np.ndarray, p: AugmentParams, out_h: int, out_w: int, color: bool) -> np.ndarray:
    """One frame through the geometry, and with `color` the brightness and
    contrast about the crop's mean."""
    if not color:
        return apply_geometry(frame, p, out_h, out_w)
    return native.augment_frame(frame, p.y0, p.x0, p.crop_h, p.crop_w, p.flip, p.brightness, p.contrast,
                                out_h, out_w)


# landmark row order (fixtures.py / face.py CANONICAL_3D): nose, chin, left
# eye, right eye, left mouth, right mouth — a horizontal flip swaps the
# left/right pairs as well as mirroring x
_FLIP_LANDMARK_ORDER = np.array([0, 1, 3, 2, 5, 4])


def apply_geometry_points(pts: np.ndarray, p: AugmentParams, in_h: int, in_w: int) -> np.ndarray:
    """Normalised (y, x) [..., 6, 2] landmarks through the same
    crop/flip/resize geometry as apply_geometry (resize keeps normalised
    coords; crop rescales; flip mirrors x AND swaps left/right rows).
    Points cropped out are clipped to the [0, 1] frame edge."""
    out = np.asarray(pts, np.float32).copy()
    y = (out[..., 0] * in_h - p.y0) / p.crop_h
    x = (out[..., 1] * in_w - p.x0) / p.crop_w
    if p.flip:
        x = 1.0 - x
        y = y[..., _FLIP_LANDMARK_ORDER]
        x = x[..., _FLIP_LANDMARK_ORDER]
    out[..., 0] = np.clip(y, 0.0, 1.0)
    out[..., 1] = np.clip(x, 0.0, 1.0)
    return out


def augment_clip(
    frames: np.ndarray,  # [T, H, W, 3] in [-1, 1]
    masks: Optional[np.ndarray],  # [T, H, W, 1] or None
    cfg: AugmentConfig,
    rng: np.random.Generator,
    points: Optional[np.ndarray] = None,  # [..., 6, 2] normalised (y, x)
    extra_maps: Optional[np.ndarray] = None,  # [T, H, W, C] continuous maps
):
    """One shared AugmentParams for the whole clip: the frames get geometry
    and colour, the masks geometry and a 0.5 threshold, the points and the
    extra maps (control renders) the same geometry.

    Returns (frames, masks[, points][, extra_maps]) in argument order."""
    if not cfg.enabled:
        out = [frames, masks]
        if points is not None:
            out.append(points)
        if extra_maps is not None:
            out.append(extra_maps)
        return tuple(out)
    _, h, w = frames.shape[:3]
    p = sample_params(cfg, rng, h, w)
    out_frames = np.stack([augment_frame(f, p, h, w, color=True) for f in frames])
    out_masks = None
    if masks is not None:
        out_masks = np.stack([
            (augment_frame(m.astype(np.float32), p, h, w, color=False) > 0.5).astype(np.float32)
            for m in masks
        ])
    out = [out_frames, out_masks]
    if points is not None:
        out.append(apply_geometry_points(points, p, h, w))
    if extra_maps is not None:
        out.append(np.stack([
            augment_frame(m.astype(np.float32), p, h, w, color=False) for m in extra_maps
        ]))
    return tuple(out)
