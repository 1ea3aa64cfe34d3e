"""Deterministic synthetic audio-visual fixtures (the port's copy of
emox/data/fixtures.py: the same seed writes the same files).

Replaces the reference's fixture generator (reference
junk/AudioAttention/synthesize.py:10-57 used AudioGen + Stable Diffusion to
make paired audio/image samples) with a zero-dependency, fixed-seed
generator: each clip is a moving "head" (ellipse) whose mouth opening tracks
the audio amplitude envelope — so audio->expression correlation actually
exists in the data and overfit tests can verify the model learns it.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


def _envelope(wav: np.ndarray, sr: int, num_frames: int, fps: float) -> np.ndarray:
    """Per-video-frame RMS amplitude of the waveform, normalised to [0,1]."""
    env = np.zeros(num_frames, np.float32)
    spf = int(sr / fps)
    for f in range(num_frames):
        seg = wav[f * spf : (f + 1) * spf]
        env[f] = np.sqrt(np.mean(seg**2)) if len(seg) else 0.0
    m = env.max()
    return env / m if m > 0 else env


def make_synthetic_clip(
    seed: int = 0,
    num_frames: int = 16,
    height: int = 64,
    width: int = 64,
    fps: float = 25.0,
    sample_rate: int = 16000,
) -> Dict[str, np.ndarray]:
    """Returns dict with:
    frames        [T, H, W, 3] float32 in [-1, 1]
    face_masks    [T, H, W, 1] float32 in {0, 1}
    wav           [S] float32
    head_centers  [T, 2] float32 (cy, cx) normalised
    pose_speeds   [T] float32 head-motion speed per frame (normalised)
    landmarks     [T, 6, 2] float32 normalised (y, x) in [0, 1]: nose, chin,
                  left/right eye outer, left/right mouth corner — the 6-point
                  set FaceLandmarkNet / PnP pose use (emox_torch.data.face
                  CANONICAL_3D; reference Net.py:872 HEAD_POSE_LANDMARKS)
    """
    rng = np.random.default_rng(seed)
    dur = num_frames / fps
    t_audio = np.arange(int(sample_rate * dur)) / sample_rate
    # speech-ish audio: AM-modulated harmonic stack with pauses
    f0 = 110 + 40 * rng.random()
    am = 0.5 + 0.5 * np.sin(2 * np.pi * (1.5 + rng.random()) * t_audio + rng.random() * 6)
    gate = (np.sin(2 * np.pi * (0.7 + 0.4 * rng.random()) * t_audio) > -0.3).astype(np.float32)
    wav = np.zeros_like(t_audio, dtype=np.float32)
    for k in range(1, 4):
        wav += np.sin(2 * np.pi * f0 * k * t_audio + rng.random() * 6).astype(np.float32) / k
    wav = (wav * am * gate * 0.3).astype(np.float32)

    env = _envelope(wav, sample_rate, num_frames, fps)

    # head trajectory: slow wander
    phase = rng.random() * 2 * np.pi
    cy = 0.5 + 0.12 * np.sin(2 * np.pi * 0.4 * np.arange(num_frames) / fps + phase)
    cx = 0.5 + 0.15 * np.sin(2 * np.pi * 0.3 * np.arange(num_frames) / fps + phase * 0.7)
    centers = np.stack([cy, cx], -1).astype(np.float32)
    speeds = np.zeros(num_frames, np.float32)
    speeds[1:] = np.linalg.norm(np.diff(centers, axis=0), axis=-1) * fps
    speeds = np.clip(speeds / 2.0, 0, 1)

    yy, xx = np.mgrid[0:height, 0:width]
    frames = np.zeros((num_frames, height, width, 3), np.float32)
    masks = np.zeros((num_frames, height, width, 1), np.float32)
    landmarks = np.zeros((num_frames, 6, 2), np.float32)
    skin = rng.random(3).astype(np.float32) * 0.4 + 0.4
    bg = rng.random(3).astype(np.float32) * 0.3 - 0.8
    for f in range(num_frames):
        fy, fx = cy[f] * height, cx[f] * width
        ry, rx = 0.28 * height, 0.22 * width
        head = ((yy - fy) / ry) ** 2 + ((xx - fx) / rx) ** 2 <= 1.0
        img = np.broadcast_to(bg, (height, width, 3)).copy()
        img[head] = skin
        # eyes
        for ex in (-0.4, 0.4):
            eye = ((yy - (fy - 0.3 * ry)) / (0.12 * ry)) ** 2 + ((xx - (fx + ex * rx)) / (0.18 * rx)) ** 2 <= 1.0
            img[eye] = (-0.6, -0.6, -0.6)
        # mouth opens with audio envelope
        mh = (0.08 + 0.35 * env[f]) * ry
        mouth = ((yy - (fy + 0.45 * ry)) / mh) ** 2 + ((xx - fx) / (0.35 * rx)) ** 2 <= 1.0
        img[mouth] = (-0.7, -0.2, -0.2)
        frames[f] = img
        masks[f, head, 0] = 1.0
        # 6-point landmark GT from the head geometry (same order as
        # emox_torch.data.face.CANONICAL_3D)
        landmarks[f] = np.array(
            [
                [fy, fx],                               # nose tip
                [fy + 0.95 * ry, fx],                   # chin
                [fy - 0.3 * ry, fx - 0.4 * rx],         # left eye outer
                [fy - 0.3 * ry, fx + 0.4 * rx],         # right eye outer
                [fy + 0.45 * ry, fx - 0.35 * rx],       # left mouth corner
                [fy + 0.45 * ry, fx + 0.35 * rx],       # right mouth corner
            ],
            np.float32,
        ) / np.array([height, width], np.float32)
    return {
        "frames": frames,
        "face_masks": masks,
        "wav": wav,
        "head_centers": centers,
        "pose_speeds": speeds,
        "landmarks": landmarks,
    }


def write_fixture_dataset(
    out_dir: str, num_clips: int = 4, seed: int = 0, num_frames: int = 16, size: int = 64, fps: float = 25.0
) -> str:
    """Writes clip .npz files + metadata json (CelebV-HQ-style clip listing,
    reference data/overfit.json / Net.py:1216-1228) into out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    clips = {}
    for i in range(num_clips):
        cid = f"synthetic_{i:03d}"
        clip = make_synthetic_clip(seed + i, num_frames, size, size, fps)
        np.savez_compressed(os.path.join(out_dir, f"{cid}.npz"), **clip)
        clips[cid] = {"frames": num_frames, "fps": fps, "height": size, "width": size}
    meta_path = os.path.join(out_dir, "metadata.json")
    with open(meta_path, "w") as f:
        json.dump({"clips": clips}, f)
    return meta_path


def synthetic_face_frame(
    rng: np.random.Generator, height: int = 128, width: int = 128
) -> Dict[str, np.ndarray]:
    """One domain-randomised synthetic face frame with landmark + mask GT —
    the training distribution for the shipped FaceLocator/FaceLandmarkNet
    weights (the trained replacement for the reference's MediaPipe
    FaceDetection + FaceMesh, reference Net.py:861-1156).

    Randomised: head position/size/aspect, in-plane rotation (roll), a
    yaw-like horizontal feature shift, skin/background colours, background
    gradient, pixel noise, brightness. Landmarks are the 6 PnP points in
    emox_torch.data.face.CANONICAL_3D order, normalised (y, x).

    Returns {"image" [H,W,3] in [-1,1], "mask" [H,W,1], "landmarks" [6,2]}.
    """
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    fy = (0.3 + 0.4 * rng.random()) * height
    fx = (0.3 + 0.4 * rng.random()) * width
    ry = (0.16 + 0.18 * rng.random()) * height
    rx = ry * (0.6 + 0.3 * rng.random()) * width / height
    roll = (rng.random() - 0.5) * 0.9  # +/- ~26 degrees
    yaw = (rng.random() - 0.5) * 0.8  # feature shift proxy for head turn
    cr, sr = np.cos(roll), np.sin(roll)

    def place(dy, dx):
        """Head-local (dy, dx) in ellipse units -> rotated pixel coords."""
        dx = dx + yaw * 0.3 * (1.0 - abs(dy))  # yaw shifts features sideways
        py = dy * ry * cr - dx * rx * sr
        px = dy * ry * sr + dx * rx * cr
        return fy + py, fx + px

    # rotated ellipse mask
    u = (yy - fy) * cr + (xx - fx) * sr
    v = -(yy - fy) * sr + (xx - fx) * cr
    head = (u / ry) ** 2 + (v / rx) ** 2 <= 1.0

    # background: gradient + noise
    bg = rng.random(3).astype(np.float32) * 0.8 - 0.9
    gdir = rng.random(2).astype(np.float32) - 0.5
    grad = (yy / height * gdir[0] + xx / width * gdir[1])[..., None] * (0.4 * rng.random())
    img = np.broadcast_to(bg, (height, width, 3)) + grad
    img = np.ascontiguousarray(img, np.float32)
    skin = rng.random(3).astype(np.float32) * 0.5 + 0.3
    img[head] = skin

    # eyes
    for ex in (-0.4, 0.4):
        ey, exx = place(-0.3, ex)
        eye = ((yy - ey) / (0.12 * ry)) ** 2 + ((xx - exx) / (0.18 * rx)) ** 2 <= 1.0
        img[eye] = (-0.6, -0.6, -0.6)
    # mouth
    my, mx = place(0.45, 0.0)
    mh = (0.08 + 0.3 * rng.random()) * ry
    mouth = ((yy - my) / mh) ** 2 + ((xx - mx) / (0.35 * rx)) ** 2 <= 1.0
    img[mouth] = (-0.7, -0.2, -0.2)

    # occasional occluder rectangle (robustness)
    if rng.random() < 0.3:
        oy, ox = rng.integers(0, height // 2), rng.integers(0, width // 2)
        oh, ow = rng.integers(4, height // 4), rng.integers(4, width // 4)
        img[oy : oy + oh, ox : ox + ow] = rng.random(3).astype(np.float32) * 2 - 1
    img = img + rng.normal(0, 0.02 + 0.04 * rng.random(), img.shape).astype(np.float32)
    img = np.clip(img + (rng.random() - 0.5) * 0.3, -1.0, 1.0).astype(np.float32)

    pts = [place(*d) for d in ((0.0, 0.0), (0.95, 0.0), (-0.3, -0.4), (-0.3, 0.4), (0.45, -0.35), (0.45, 0.35))]
    landmarks = np.asarray(pts, np.float32) / np.array([height, width], np.float32)
    return {
        "image": img,
        "mask": head[..., None].astype(np.float32),
        "landmarks": np.clip(landmarks, 0.0, 1.0),
    }


def synthetic_face_batch(rng: np.random.Generator, batch: int, height: int = 128, width: int = 128):
    items = [synthetic_face_frame(rng, height, width) for _ in range(batch)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
