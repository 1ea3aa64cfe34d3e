"""Face-region masks + head-pose math (the port's copy of emox/data/face.py).

Capability-parity rework of the reference FaceHelper (reference
Net.py:861-1156): padded-bbox face masks, PnP head pose (yaw/pitch/roll)
from 6 canonical landmarks, per-frame pose-velocity series.

MediaPipe is not a dependency here. Landmarks come from any provider:
  * explicit landmark arrays (e.g. exported offline by any detector),
  * the trained emox FaceLocator model's mask -> bbox/centroid (the
    reference's own stage-0 design, reference Net.py:819-855),
  * a geometric prior fallback (centre ellipse) for bootstrap/testing.
All outputs are plain numpy — this runs offline in precompute, never on
the serving or training path. The trained providers run the port's
FaceLocator and FaceLandmarkNet (torch) on the card unless told otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from emox_torch.utils.optional import cv2 as _cv2

# canonical 3D face model points for the 6 PnP landmarks the reference uses
# (nose tip, chin, left/right eye outer corner, left/right mouth corner —
# reference Net.py:872 HEAD_POSE_LANDMARKS indexes the same feature set)
CANONICAL_3D = np.array(
    [
        [0.0, 0.0, 0.0],        # nose tip
        [0.0, -330.0, -65.0],   # chin
        [-225.0, 170.0, -135.0],  # left eye outer
        [225.0, 170.0, -135.0],   # right eye outer
        [-150.0, -150.0, -125.0],  # left mouth corner
        [150.0, -150.0, -125.0],   # right mouth corner
    ],
    dtype=np.float64,
)


def camera_matrix(height: int, width: int) -> np.ndarray:
    """Pinhole intrinsics with focal = 1.28 * height (reference camera.py:51-58)."""
    focal = 1.28 * height
    return np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]], dtype=np.float64)


def head_pose_from_landmarks(landmarks_2d: np.ndarray, height: int, width: int) -> Optional[np.ndarray]:
    """6x2 pixel landmarks -> (pitch, yaw, roll) degrees via solvePnP +
    Rodrigues (reference Net.py:995-1076 get_head_pose)."""
    cv2 = _cv2()
    if cv2 is None:
        return None
    lm = np.asarray(landmarks_2d, np.float64).reshape(6, 2)
    ok, rvec, _ = cv2.solvePnP(CANONICAL_3D, lm, camera_matrix(height, width), np.zeros((4, 1)))
    if not ok:
        return None
    rmat, _ = cv2.Rodrigues(rvec)
    sy = np.sqrt(rmat[0, 0] ** 2 + rmat[1, 0] ** 2)
    if sy > 1e-6:
        pitch = np.arctan2(rmat[2, 1], rmat[2, 2])
        yaw = np.arctan2(-rmat[2, 0], sy)
        roll = np.arctan2(rmat[1, 0], rmat[0, 0])
    else:
        pitch = np.arctan2(-rmat[1, 2], rmat[1, 1])
        yaw = np.arctan2(-rmat[2, 0], sy)
        roll = 0.0
    return np.degrees([pitch, yaw, roll]).astype(np.float32)


def pose_velocities(poses: np.ndarray, fps: float = 25.0, normalize: float = 180.0) -> np.ndarray:
    """[T, 3] euler degrees -> [T] scalar head-rotation speed per frame,
    normalised to roughly [-1, 1] territory for the speed buckets
    (reference Net.py:1089-1156 get_head_pose_velocities_at_frame)."""
    t = poses.shape[0]
    v = np.zeros(t, np.float32)
    if t > 1:
        d = np.diff(poses, axis=0) * fps / normalize  # deg/s scaled
        v[1:] = np.linalg.norm(d, axis=-1)
    return np.clip(v, 0.0, 1.0)


def pose_velocities_3d(poses: np.ndarray, fps: float = 25.0, normalize: float = 180.0) -> np.ndarray:
    """[T, 3] euler degrees -> [T, 3] SIGNED per-axis velocities in [-1, 1].

    The reference buckets each rotation axis separately (vector input to
    SpeedEncoder, reference Net.py:248-258) — a scalar ||d pose|| loses the
    head-turn direction. Feed this to models with speed_axes=3."""
    t = poses.shape[0]
    v = np.zeros((t, 3), np.float32)
    if t > 1:
        v[1:] = np.diff(poses, axis=0) * fps / normalize
    return np.clip(v, -1.0, 1.0)


def _draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """Dense-sampled line into [H, W, 3] float frame, in place."""
    h, w = img.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    n = int(np.ceil(2.0 * np.abs(p1 - p0).max())) + 1
    pts = np.round(np.linspace(p0, p1, n)).astype(np.int64)
    for dy in range(-thickness + 1, thickness):
        for dx in range(-thickness + 1, thickness):
            ys = np.clip(pts[:, 0] + dy, 0, h - 1)
            xs = np.clip(pts[:, 1] + dx, 0, w - 1)
            img[ys, xs] = color


def draw_pose_axes(
    frame: np.ndarray, pose_deg: np.ndarray, anchor_yx: np.ndarray, length: float = 0.25
) -> np.ndarray:
    """Head-pose axis debug overlay (reference Net.py:1077-1087 draw_axis,
    which writes *_debug.jpg overlays during dataset prep).

    frame [H, W, 3] in [-1, 1]; pose_deg (pitch, yaw, roll) degrees;
    anchor_yx normalised (y, x) anchor (nose tip). Projects the canonical
    X (red, right) / Y (green, down) / Z (blue, toward camera) axes into
    the image plane with the classic in-plane formula and returns a copy
    with the overlay drawn. Pure numpy — debug/offline only."""
    h, w = frame.shape[:2]
    pitch, yaw, roll = np.radians(np.asarray(pose_deg, np.float64))
    ln = length * min(h, w)
    cy, cx = float(anchor_yx[0]) * h, float(anchor_yx[1]) * w
    dx1 = ln * (np.cos(yaw) * np.cos(roll))
    dy1 = ln * (np.cos(pitch) * np.sin(roll) + np.cos(roll) * np.sin(pitch) * np.sin(yaw))
    dx2 = ln * (-np.cos(yaw) * np.sin(roll))
    dy2 = ln * (np.cos(pitch) * np.cos(roll) - np.sin(pitch) * np.sin(yaw) * np.sin(roll))
    dx3 = ln * np.sin(yaw)
    dy3 = ln * (-np.cos(yaw) * np.sin(pitch))
    out = np.asarray(frame, np.float32).copy()
    for (dy, dx), color in (
        ((dy1, dx1), (1.0, -1.0, -1.0)),   # X: red
        ((dy2, dx2), (-1.0, 1.0, -1.0)),   # Y: green
        ((dy3, dx3), (-1.0, -1.0, 1.0)),   # Z: blue
    ):
        _draw_line(out, (cy, cx), (cy + dy, cx + dx), color)
    return out


def pose_debug_overlay(
    frames: np.ndarray, landmarks_norm: np.ndarray, frame_index: int = 0
) -> Optional[np.ndarray]:
    """Cache-ready debug render: re-derive the head pose from the stored
    normalised (y, x) landmarks and overlay the axes on one frame.
    Returns None when pose recovery is unavailable (no cv2)."""
    fr = np.asarray(frames[frame_index])
    lm = np.asarray(landmarks_norm[frame_index], np.float32)
    h, w = fr.shape[:2]
    px = np.stack([lm[:, 1] * w, lm[:, 0] * h], axis=-1)  # norm (y,x) -> pixel (x,y)
    pose = head_pose_from_landmarks(px, h, w)
    if pose is None:
        return None
    return draw_pose_axes(fr, pose, lm[0])  # anchor at the nose tip


def mask_from_bbox(height: int, width: int, bbox: Tuple[int, int, int, int], pad_ratio: float = 0.1) -> np.ndarray:
    """Padded bbox -> binary [H, W, 1] mask (reference Net.py:881-926
    generate_face_region_mask semantics)."""
    x0, y0, x1, y1 = bbox
    pw, ph = int((x1 - x0) * pad_ratio), int((y1 - y0) * pad_ratio)
    x0, y0 = max(0, x0 - pw), max(0, y0 - ph)
    x1, y1 = min(width, x1 + pw), min(height, y1 + ph)
    m = np.zeros((height, width, 1), np.float32)
    m[y0:y1, x0:x1] = 1.0
    return m


def mask_from_probability(prob: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """FaceLocator sigmoid output [H, W, 1] -> bbox mask."""
    binary = prob[..., 0] > threshold
    ys, xs = np.where(binary)
    h, w = prob.shape[:2]
    if len(ys) == 0:
        return geometric_prior_mask(h, w)
    return mask_from_bbox(h, w, (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1))


def geometric_prior_mask(height: int, width: int) -> np.ndarray:
    """Centre-weighted prior for bootstrap when no detector is available:
    portrait datasets (CelebV-HQ crops) centre the face."""
    yy, xx = np.mgrid[0:height, 0:width]
    e = ((yy - 0.45 * height) / (0.38 * height)) ** 2 + ((xx - 0.5 * width) / (0.32 * width)) ** 2 <= 1.0
    return e[..., None].astype(np.float32)


class FaceHelper:
    """Mask + pose provider with pluggable landmark source."""

    def __init__(self, landmark_fn=None, locator_fn=None):
        """landmark_fn(frame_rgb_u8) -> [6, 2] pixel landmarks or None;
        locator_fn(frame_float[-1,1]) -> [H, W, 1] probability mask."""
        self.landmark_fn = landmark_fn
        self.locator_fn = locator_fn

    @classmethod
    def from_model(cls, model, batch_size: int = 16) -> "FaceHelper":
        """Provider backed by the stage-0 nets of the port's EMOModel (its
        weights, on its device): FaceLocator for masks, FaceLandmarkNet for
        the 6 PnP landmarks, in place of the reference's MediaPipe
        FaceDetection + FaceMesh (reference Net.py:861-1156). Frames go
        through the nets one at a time, as the reference's provider takes
        them; batch_size is the reference's argument, which it does not
        use either."""

        def locator_fn(frame: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                x = torch.as_tensor(np.asarray(frame, np.float32))[None]
                return torch.sigmoid(model.locate_face(x).float())[0].cpu().numpy()

        def landmark_fn(frame: np.ndarray) -> np.ndarray:
            f = np.asarray(frame, np.float32)
            if f.max() > 1.5:  # u8-ranged input
                f = f / 127.5 - 1.0
            with torch.no_grad():
                lm = model.locate_landmarks(torch.as_tensor(f)[None]).float()[0].cpu().numpy()  # (y, x) in [0,1]
            h, w = frame.shape[:2]
            return np.stack([lm[:, 1] * w, lm[:, 0] * h], axis=-1)  # pixel (x, y)

        return cls(landmark_fn=landmark_fn, locator_fn=locator_fn)

    @classmethod
    def from_asset(cls, path: Optional[str] = None,
                   device: Optional[Union[str, torch.device]] = None) -> Optional["FaceHelper"]:
        """Provider backed by trained face nets stored as the reference
        ships them (an npz of flax leaves, emox_torch.train.face_nets), run
        on `device`: the CUDA card unless told otherwise. With no path, the
        port's own asset (emox_torch/assets/face_nets.npz, which
        `python -m emox_torch train-face` writes) where it exists, else the
        file the repository ships beside the reference
        (emox/assets/face_nets.npz), read as data. Returns None when there
        is no such file: the zero-setup provider for `precompute` on a bare
        video."""
        from emox_torch.core.device import resolve_device
        from emox_torch.interop.from_flax import load_module
        from emox_torch.nn.conditioners import FaceLandmarkNet, FaceLocator
        from emox_torch.train.face_nets import default_asset_path, load_face_nets

        dev = resolve_device(device)
        params = load_face_nets(path or default_asset_path())
        if params is None:
            return None
        with torch.device(dev):
            locator, landmarker = FaceLocator().eval(), FaceLandmarkNet().eval()
        load_module(locator, params["face_locator"], "face_locator")
        load_module(landmarker, params["landmarker"], "landmarker")

        def unit(frame: np.ndarray) -> torch.Tensor:
            f = np.asarray(frame, np.float32)
            if f.max() > 1.5:
                f = f / 127.5 - 1.0
            return torch.as_tensor(f, device=dev)[None]

        def locator_fn(frame: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                return torch.sigmoid(locator(unit(frame)))[0].cpu().numpy()

        def landmark_fn(frame: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                lm = landmarker(unit(frame))[0].float().cpu().numpy()  # [6, 2] (y, x) in [0,1]
            h, w = frame.shape[:2]
            return np.stack([lm[:, 1] * w, lm[:, 0] * h], axis=-1)  # pixel (x, y)

        return cls(landmark_fn=landmark_fn, locator_fn=locator_fn)

    @classmethod
    def from_landmark_file(cls, path: str) -> "FaceHelper":
        """Provider over an external landmark export: .npy [T, 6, 2] pixel
        (x, y) landmarks from any offline detector. Frames are consumed in
        order (one call per frame)."""
        arr = np.load(path).astype(np.float64)
        if arr.ndim != 3 or arr.shape[1:] != (6, 2):
            raise ValueError(f"landmark file {path} must be [T, 6, 2], got {arr.shape}")
        # mask and pose passes iterate the clip independently -> own counters
        counters = {"lm": 0, "mask": 0}

        def take(which):
            i = counters[which]
            counters[which] = i + 1
            return arr[min(i, len(arr) - 1)]

        def landmark_fn(frame: np.ndarray):
            return take("lm")

        def locator_fn(frame: np.ndarray) -> np.ndarray:
            # bbox mask straight from the landmark extent
            h, w = frame.shape[:2]
            lm = take("mask")
            return mask_from_bbox(
                h, w,
                (int(lm[:, 0].min()), int(lm[:, 1].min()), int(lm[:, 0].max()) + 1, int(lm[:, 1].max()) + 1),
                pad_ratio=0.35,
            )

        return cls(landmark_fn=landmark_fn, locator_fn=locator_fn)

    def face_mask(self, frame: np.ndarray) -> np.ndarray:
        h, w = frame.shape[:2]
        if self.locator_fn is not None:
            return mask_from_probability(np.asarray(self.locator_fn(frame)))
        return geometric_prior_mask(h, w)

    def head_pose(self, frame: np.ndarray) -> Optional[np.ndarray]:
        if self.landmark_fn is None:
            return None
        lm = self.landmark_fn(frame)
        if lm is None:
            return None
        return head_pose_from_landmarks(lm, frame.shape[0], frame.shape[1])

    def pose_speed_series(self, frames: Sequence[np.ndarray], fps: float = 25.0) -> np.ndarray:
        poses = []
        last = np.zeros(3, np.float32)
        for fr in frames:
            p = self.head_pose(fr)
            last = p if p is not None else last
            poses.append(last)
        return pose_velocities(np.stack(poses), fps)


# connection pairs over the 6 canonical points (indices into CANONICAL_3D):
# eye line, nose->chin axis, mouth line, nose->eyes, chin->mouth corners
_SKELETON_EDGES = ((2, 3), (0, 1), (4, 5), (0, 2), (0, 3), (1, 4), (1, 5))


def render_landmark_skeleton(
    landmarks_norm: np.ndarray, height: int, width: int, radius: float = 0.02, sigma: float = 0.012
) -> np.ndarray:
    """Normalised (y, x) [T, 6, 2] landmark series -> dense conditioning
    renders [T, H, W, 3] in [0, 1]: gaussian keypoint blobs (R), skeleton
    line segments (G), and the nose->chin pose axis emphasised (B) — the
    ControlNet conditioning-signal class the reference intends (reference
    magicanimate/models/controlnet.py:49-91 cond embedding over dense pose
    images). Pure numpy, offline only.
    """
    lm = np.asarray(landmarks_norm, np.float32)
    t = lm.shape[0]
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    yn, xn = yy / height, xx / width
    sig2 = 2.0 * sigma * sigma
    line_w = max(radius * 0.35, 1.5 / max(height, width))
    out = np.zeros((t, height, width, 3), np.float32)

    def seg_dist(p0, p1):
        """Distance from every pixel to segment p0-p1 (normalised coords)."""
        d = p1 - p0
        denom = float(d @ d) + 1e-12
        tt = ((yn - p0[0]) * d[0] + (xn - p0[1]) * d[1]) / denom
        tt = np.clip(tt, 0.0, 1.0)
        cy = p0[0] + tt * d[0]
        cx = p0[1] + tt * d[1]
        return np.sqrt((yn - cy) ** 2 + (xn - cx) ** 2)

    for f in range(t):
        pts = lm[f]
        blobs = np.zeros((height, width), np.float32)
        for p in pts:
            blobs = np.maximum(blobs, np.exp(-((yn - p[0]) ** 2 + (xn - p[1]) ** 2) / sig2))
        lines = np.zeros((height, width), np.float32)
        for a, b in _SKELETON_EDGES:
            lines = np.maximum(lines, (seg_dist(pts[a], pts[b]) < line_w).astype(np.float32))
        axis = (seg_dist(pts[0], pts[1]) < line_w * 1.5).astype(np.float32)
        out[f, ..., 0] = blobs
        out[f, ..., 1] = lines
        out[f, ..., 2] = axis
    return out
