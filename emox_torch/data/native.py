"""The host data path's array functions in numpy (the port's copy of the
numpy branches of emox/data/native.py).

The reference binds these to a C library of its own (under native/) that it
builds with `make` on first use and falls back to numpy without it. The
port keeps only the numpy versions: it loads, builds and runs nothing, so
its data loader threads never race to build a library. Each function gives
the same result as the reference's numpy branch, bit for bit.
"""

from __future__ import annotations

import numpy as np


def resample_linear(wav: np.ndarray, src_rate: float, dst_rate: float) -> np.ndarray:
    """Linear-interpolation resampling of a mono waveform."""
    wav = np.ascontiguousarray(wav, np.float32)
    n_dst = int(round(len(wav) * dst_rate / src_rate))
    pos = np.arange(n_dst) * (src_rate / dst_rate)
    return np.interp(pos, np.arange(len(wav)), wav).astype(np.float32)


def wav_window(wav: np.ndarray, start: int, length: int) -> np.ndarray:
    """wav[start:start + length], zero where the window leaves the wave."""
    wav = np.ascontiguousarray(wav, np.float32)
    out = np.zeros(length, np.float32)
    a, b = max(0, start), min(len(wav), start + length)
    if b > a:
        out[a - start: b - start] = wav[a:b]
    return out


def u8_to_unit(img: np.ndarray) -> np.ndarray:
    """uint8 pixels -> float32 in [-1, 1]."""
    img = np.ascontiguousarray(img, np.uint8)
    return img.astype(np.float32) / 127.5 - 1.0


def unit_to_u8(img: np.ndarray) -> np.ndarray:
    """float32 in [-1, 1] -> uint8 pixels, rounded and clipped."""
    img = np.ascontiguousarray(img, np.float32)
    return np.clip((img + 1.0) * 127.5, 0, 255).round().astype(np.uint8)


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """float32 [H, W, C] -> [dh, dw, C] (half-pixel centers)."""
    img = np.ascontiguousarray(img, np.float32)
    sh, sw, _ = img.shape
    ys = np.clip((np.arange(dh) + 0.5) * sh / dh - 0.5, 0, sh - 1)
    xs = np.clip((np.arange(dw) + 0.5) * sw / dw - 0.5, 0, sw - 1)
    y0 = ys.astype(int); y1 = np.minimum(y0 + 1, sh - 1); wy = (ys - y0)[:, None, None]
    x0 = xs.astype(int); x1 = np.minimum(x0 + 1, sw - 1); wx = (xs - x0)[None, :, None]
    out = ((1 - wy) * ((1 - wx) * img[y0][:, x0] + wx * img[y0][:, x1])
           + wy * ((1 - wx) * img[y1][:, x0] + wx * img[y1][:, x1]))
    return out.astype(np.float32)


def augment_frame(img: np.ndarray, y0: int, x0: int, ch: int, cw: int, flip: bool,
                  brightness: float, contrast: float, dh: int, dw: int) -> np.ndarray:
    """Crop [y0:y0+ch, x0:x0+cw], flip, resize to [dh, dw], then
    brightness/contrast about the crop's mean, clipped to [-1, 1]: what the
    reference's augment_frame computes for a frame without its C library."""
    out = img[y0: y0 + ch, x0: x0 + cw]
    if flip:
        out = out[:, ::-1]
    if out.shape[:2] != (dh, dw):
        out = resize_bilinear(np.ascontiguousarray(out, np.float32), dh, dw)
    pivot = float(img[y0: y0 + ch, x0: x0 + cw].mean())
    return np.clip((out - pivot) * contrast + pivot + brightness, -1.0, 1.0).astype(np.float32)


def rms_envelope(wav: np.ndarray, samples_per_frame: float, frames: int) -> np.ndarray:
    """Per-frame RMS of a waveform."""
    wav = np.ascontiguousarray(wav, np.float32)
    out = np.zeros(frames, np.float32)
    for f in range(frames):
        a, b = int(f * samples_per_frame), min(int((f + 1) * samples_per_frame), len(wav))
        out[f] = np.sqrt(np.mean(wav[a:b] ** 2)) if b > a else 0.0
    return out
