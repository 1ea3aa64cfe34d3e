"""Camera intrinsics and checkerboard calibration (counterpart of
emox/data/camera.py).

A pinhole Camera with the heuristic focal length 1.28 * height, the
Checkerboard's inner-corner grid and detection, and a Calibrator that
accumulates views into a calibrated Camera (intrinsic matrix and
distortion). The head-pose solver takes such a camera where a calibration
exists; emox_torch.data.face.camera_matrix gives the heuristic intrinsics
otherwise. numpy, with cv2 where it is installed: without cv2, projection
is the plain pinhole formula, undistort returns the image, corner
detection finds nothing and calibrate returns None. Offline only; nothing
here runs on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from emox_torch.utils.optional import cv2 as _cv2


@dataclass
class Camera:
    """Pinhole model. The heuristic focal length 1.28 * height is
    emox_torch.data.face.camera_matrix's."""

    width: int
    height: int
    matrix: Optional[np.ndarray] = None
    distortion: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.matrix is None:
            f = 1.28 * self.height
            self.matrix = np.array(
                [[f, 0, self.width / 2], [0, f, self.height / 2], [0, 0, 1]], np.float64
            )
        if self.distortion is None:
            self.distortion = np.zeros((5, 1), np.float64)

    @property
    def focal(self) -> float:
        return float(self.matrix[0, 0])

    def undistort(self, image: np.ndarray) -> np.ndarray:
        cv2 = _cv2()
        if cv2 is None:
            return image
        return cv2.undistort(image, self.matrix, self.distortion)

    def project(self, points_3d: np.ndarray, rvec=None, tvec=None) -> np.ndarray:
        """[N, 3] world points -> [N, 2] pixels."""
        cv2 = _cv2()
        if cv2 is not None:
            r = np.zeros(3) if rvec is None else rvec
            t = np.zeros(3) if tvec is None else tvec
            out, _ = cv2.projectPoints(points_3d.astype(np.float64), r, t, self.matrix, self.distortion)
            return out.reshape(-1, 2)
        p = points_3d / np.maximum(points_3d[:, 2:3], 1e-9)
        return (self.matrix @ np.concatenate([p[:, :2], np.ones((len(p), 1))], 1).T).T[:, :2]


@dataclass
class Checkerboard:
    """The grid of inner corners of a checkerboard."""

    rows: int = 6
    cols: int = 9
    square_size: float = 1.0

    def object_points(self) -> np.ndarray:
        """[rows*cols, 3] planar grid in board coordinates."""
        grid = np.mgrid[0 : self.cols, 0 : self.rows].T.reshape(-1, 2)
        pts = np.zeros((self.rows * self.cols, 3), np.float32)
        pts[:, :2] = grid * self.square_size
        return pts

    def find_corners(self, gray: np.ndarray) -> Optional[np.ndarray]:
        cv2 = _cv2()
        if cv2 is None:
            return None
        ok, corners = cv2.findChessboardCorners(gray, (self.cols, self.rows))
        if not ok:
            return None
        crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.001)
        return cv2.cornerSubPix(gray, corners, (11, 11), (-1, -1), crit)


@dataclass
class Calibrator:
    """Accumulate checkerboard views -> a calibrated Camera."""

    board: Checkerboard = field(default_factory=Checkerboard)
    _obj: List[np.ndarray] = field(default_factory=list)
    _img: List[np.ndarray] = field(default_factory=list)
    _size: Optional[Tuple[int, int]] = None

    def add_view(self, image: np.ndarray) -> bool:
        cv2 = _cv2()
        if cv2 is None:
            return False
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY) if image.ndim == 3 else image
        corners = self.board.find_corners(gray)
        if corners is None:
            return False
        self._obj.append(self.board.object_points())
        self._img.append(corners)
        self._size = (gray.shape[1], gray.shape[0])
        return True

    @property
    def num_views(self) -> int:
        return len(self._obj)

    def calibrate(self) -> Optional[Camera]:
        cv2 = _cv2()
        if cv2 is None or not self._obj:
            return None
        err, mtx, dist, _, _ = cv2.calibrateCamera(self._obj, self._img, self._size, None, None)
        w, h = self._size
        return Camera(width=w, height=h, matrix=mtx, distortion=dist)
