"""Offline preprocessing: video/audio -> cached training arrays (the port's
copy of emox/data/precompute.py; a fixture clip gives the same arrays).

The reference did ALL of this inside Dataset.__getitem__ per step (decord
decode, MediaPipe masks, PnP pose, wav2vec2 features — reference
Net.py:1254-1445), starving the accelerator. Here it runs once, offline,
writing one .npz per clip; the training loader only does array slicing.

Sources: .mp4 (decoded via cv2.VideoCapture + ffmpeg wav extraction when
available) or pre-made .npz fixture clips.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, Optional, Union

import numpy as np
import torch

from emox_torch.data.face import FaceHelper

from emox_torch.utils.optional import cv2 as _cv2


def read_video_frames(
    path: str,
    width: int,
    height: int,
    max_frames: Optional[int] = None,
    bbox: Optional[Dict[str, float]] = None,
    time_window: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """mp4 -> [T, H, W, 3] float32 in [-1, 1] (cv2 replaces the reference's
    decord/PyAV readers, reference Net.py:1163-1186, videoreader.py:31-156).

    bbox: CelebV-HQ-style fractional crop {top, bottom, left, right} and
    time_window {start_sec, end_sec} (reference ExtractFrames.py:22-85:
    crop clips out of source videos by metadata bbox/time).
    """
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("cv2 unavailable; provide .npz clips instead")
    cap = cv2.VideoCapture(path)
    fps_src = cap.get(cv2.CAP_PROP_FPS) or 25.0
    start_f = int((time_window or {}).get("start_sec", 0) * fps_src)
    end_f = (time_window or {}).get("end_sec")
    end_f = int(end_f * fps_src) if end_f is not None else None
    if start_f:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start_f)
    frames = []
    fi = start_f
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames and len(frames) >= max_frames) or (end_f is not None and fi >= end_f):
            break
        fi += 1
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if bbox:
            h0, w0 = frame.shape[:2]
            y0 = int(bbox.get("top", 0.0) * h0)
            y1 = int(bbox.get("bottom", 1.0) * h0)
            x0 = int(bbox.get("left", 0.0) * w0)
            x1 = int(bbox.get("right", 1.0) * w0)
            frame = frame[max(0, y0) : min(h0, y1), max(0, x0) : min(w0, x1)]
        frame = cv2.resize(frame, (width, height), interpolation=cv2.INTER_AREA)
        frames.append(frame.astype(np.float32) / 127.5 - 1.0)
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def extract_wav(path: str, sample_rate: int = 16000) -> Optional[np.ndarray]:
    """mp4 -> mono float32 waveform via ffmpeg (the reference used
    moviepy+librosa, reference Net.py:628-644)."""
    try:
        out = subprocess.run(
            ["ffmpeg", "-v", "quiet", "-i", path, "-f", "f32le", "-ac", "1", "-ar", str(sample_rate), "-"],
            capture_output=True, check=True,
        ).stdout
        return np.frombuffer(out, np.float32).copy()
    except (OSError, subprocess.CalledProcessError):
        return None


def resample_linear(wav: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear-interpolation resampler (librosa replacement for our rates)."""
    if src_rate == dst_rate:
        return wav.astype(np.float32)
    from emox_torch.data import native

    return native.resample_linear(wav, float(src_rate), float(dst_rate))


def precompute_clip(
    src_path: str,
    out_path: str,
    width: int = 256,
    height: int = 256,
    fps: float = 25.0,
    sample_rate: int = 16000,
    face_helper: Optional[FaceHelper] = None,
    max_frames: Optional[int] = None,
    clip_meta: Optional[Dict] = None,  # CelebV-HQ entry: bbox / duration
    with_control: bool = True,  # write stage-4 landmark-skeleton renders
    device: Optional[Union[str, torch.device]] = None,  # of the default face provider
) -> Dict[str, np.ndarray]:
    """One clip -> {frames, face_masks, wav, pose_speeds, pose_vel3
    (+landmarks when available)} npz.

    Landmark sources, in priority order: a sibling `<src>.landmarks.npy`
    export ([T, 6, 2] pixel (x, y) from any offline detector), the given
    face_helper's landmark_fn (e.g. FaceHelper.from_model on a trained
    stage-0 checkpoint), fixture ground truth inside a .npz clip. With no
    face_helper the trained face nets (FaceHelper.from_asset) provide masks
    and landmarks, on `device`: the CUDA card unless told otherwise.
    """
    landmarks = None
    lm_path = os.path.splitext(src_path)[0] + ".landmarks.npy"
    if os.path.exists(lm_path) and face_helper is None:
        face_helper = FaceHelper.from_landmark_file(lm_path)
    if src_path.endswith(".npz"):
        clip = dict(np.load(src_path))
        frames = clip["frames"]
        if max_frames:
            frames = frames[:max_frames]
        wav = clip.get("wav", np.zeros(int(len(frames) / fps * sample_rate), np.float32))
        masks = clip.get("face_masks")
        speeds = clip.get("pose_speeds")
        vel3 = clip.get("pose_vel3")
        landmarks = clip.get("landmarks")
    else:
        meta = clip_meta or {}
        frames = read_video_frames(
            src_path, width, height, max_frames,
            bbox=meta.get("bbox"), time_window=meta.get("duration"),
        )
        wav = extract_wav(src_path, sample_rate)
        if wav is not None and meta.get("duration"):
            s0 = int(meta["duration"].get("start_sec", 0) * sample_rate)
            s1 = meta["duration"].get("end_sec")
            wav = wav[s0 : int(s1 * sample_rate) if s1 is not None else None]
        if wav is None:
            wav = np.zeros(int(len(frames) / fps * sample_rate), np.float32)
        masks = speeds = vel3 = None

    fh = face_helper
    if fh is None:
        # the trained face nets (FaceHelper.from_asset) are the zero-setup
        # default — a bare mp4 gets real masks + nonzero pose velocities;
        # geometric-prior fallback only when no asset exists
        fh = FaceHelper.from_asset(device=device) or FaceHelper()
    if masks is None:
        masks = np.stack([fh.face_mask(f) for f in frames])
    if fh.landmark_fn is not None and (speeds is None or vel3 is None or landmarks is None):
        # one landmark detection per frame feeds pose series (scalar speeds
        # AND signed per-axis velocities) plus the persisted normalised
        # (y, x) landmark targets. Clip-provided ground truth is never
        # overwritten — only missing keys are filled.
        from emox_torch.data.face import head_pose_from_landmarks, pose_velocities, pose_velocities_3d

        h, w = frames.shape[1:3]
        lms, poses, last = [], [], np.zeros(3, np.float32)
        for fr in frames:
            lm = fh.landmark_fn(fr)
            if lm is not None:
                lm = np.asarray(lm, np.float32)
                p = head_pose_from_landmarks(lm, h, w)
                last = p if p is not None else last
                lms.append(np.stack([lm[:, 1] / h, lm[:, 0] / w], axis=-1))  # pixel (x,y) -> norm (y,x)
            else:
                lms.append(np.full((6, 2), 0.5, np.float32))
            poses.append(last)
        poses = np.stack(poses)
        if speeds is None:
            speeds = pose_velocities(poses, fps)
        if vel3 is None:
            vel3 = pose_velocities_3d(poses, fps)
        if landmarks is None:
            landmarks = np.clip(np.stack(lms), 0.0, 1.0)
    if speeds is None or vel3 is None:
        # ADVICE r2: silently-zero velocities let stage-3 train its speed
        # conditioning on constants — make the gap loud
        import warnings

        warnings.warn(
            f"{src_path}: no landmark source (no shipped face-net asset, no "
            "<clip>.landmarks.npy, no --face-ckpt) — pose velocities written "
            "as zeros; stage-3 speed conditioning would train on constants",
            stacklevel=2,
        )
    if speeds is None:
        speeds = np.zeros(len(frames), np.float32)
    if vel3 is None:
        vel3 = np.zeros((len(frames), 3), np.float32)
    out = {
        "frames": frames.astype(np.float32),
        "face_masks": masks.astype(np.float32),
        "wav": wav.astype(np.float32),
        "pose_speeds": speeds.astype(np.float32),
        "pose_vel3": vel3.astype(np.float32),
    }
    if landmarks is not None:
        out["landmarks"] = np.asarray(landmarks, np.float32)[: len(frames)]
        if with_control:
            # dense ControlNet conditioning: landmark-skeleton pose renders
            # (the signal class the reference's controlnet conditions on,
            # reference magicanimate/models/controlnet.py:49-91) — stage 4
            # trains on these instead of the face-mask fallback. Stored
            # uint8: 4x smaller than float32 at [T, H, W, 3] full res;
            # the dataset rescales to [0, 1] float at fetch time.
            from emox_torch.data.face import render_landmark_skeleton

            h_, w_ = frames.shape[1:3]
            render = render_landmark_skeleton(out["landmarks"], h_, w_)
            out["control"] = (render * 255.0 + 0.5).astype(np.uint8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez_compressed(out_path, **out)
    return out


def precompute_dataset(
    metadata_json: str,
    video_dir: str,
    cache_dir: str,
    width: int = 256,
    height: int = 256,
    fps: float = 25.0,
    face_helper: Optional[FaceHelper] = None,
    with_control: bool = True,
    skip_existing: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """CelebV-HQ-style metadata {clips: {id: ...}} -> cache of npz files +
    cache manifest (reference ExtractFrames.py:22-85 + EMODataset wiring).

    skip_existing makes re-runs resumable: a clip whose cache npz is
    already newer than its source is manifest-listed without re-running
    the CV pipeline (at the reference's CelebV-HQ scale of 36,000 clips,
    reference README.md:113-117, a restart must not redo days of work).
    `device` is the default face provider's (precompute_clip)."""
    with open(metadata_json) as f:
        meta = json.load(f)
    os.makedirs(cache_dir, exist_ok=True)
    manifest = {}
    for cid, centry in meta["clips"].items():
        src = None
        for ext in (".mp4", ".npz"):
            cand = os.path.join(video_dir, cid + ext)
            if os.path.exists(cand):
                src = cand
                break
        if src is None and isinstance(centry, dict) and centry.get("ytb_id"):
            # CelebV-HQ layout: clip is cut out of the source video by
            # bbox/time metadata (reference ExtractFrames.py:22-85)
            for ext in (".mp4", ".npz"):
                cand = os.path.join(video_dir, centry["ytb_id"] + ext)
                if os.path.exists(cand):
                    src = cand
                    break
        if src is None:
            continue
        out_path = os.path.join(cache_dir, cid + ".npz")
        if (
            skip_existing
            and os.path.exists(out_path)
            and os.path.getmtime(out_path) >= os.path.getmtime(src)
        ):
            with np.load(out_path) as done:
                n_frames = int(done["frames"].shape[0])
            manifest[cid] = {"frames": n_frames, "path": out_path}
            continue
        clip = precompute_clip(
            src, out_path, width, height, fps, face_helper=face_helper,
            clip_meta=centry if isinstance(centry, dict) else None,
            with_control=with_control, device=device,
        )
        manifest[cid] = {"frames": int(clip["frames"].shape[0]), "path": out_path}
    man_path = os.path.join(cache_dir, "manifest.json")
    with open(man_path, "w") as f:
        json.dump(manifest, f)
    return man_path
