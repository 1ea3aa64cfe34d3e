"""The port's camera utilities (emox_torch.data.camera) against the
reference's (emox/data/camera.py): the checks of tests/test_utils.py's
TestCamera on both, and a Calibrator run with cv2 on synthetic projected
checkerboards, whose intrinsics and distortion must equal the reference's."""

from __future__ import annotations

import numpy as np
import pytest

from emox.data import camera as jcamera
from emox_torch.data import camera as tcamera

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("mod", [jcamera, tcamera], ids=["reference", "port"])
def test_heuristic_intrinsics(mod):
    cam = mod.Camera(width=640, height=480)
    assert abs(cam.focal - 1.28 * 480) < 1e-6
    assert cam.matrix[0, 2] == 320 and cam.matrix[1, 2] == 240
    np.testing.assert_array_equal(cam.matrix, jcamera.Camera(width=640, height=480).matrix)


@pytest.mark.parametrize("mod", [jcamera, tcamera], ids=["reference", "port"])
def test_project_center(mod):
    cam = mod.Camera(width=100, height=100)
    px = cam.project(np.array([[0.0, 0.0, 10.0]]))
    np.testing.assert_allclose(px[0], [50.0, 50.0], atol=1e-6)


def test_checkerboard_object_points():
    b = tcamera.Checkerboard(rows=3, cols=4, square_size=2.0)
    pts = b.object_points()
    assert pts.shape == (12, 3) and pts[:, 2].max() == 0.0 and pts[:, :2].max() == 6.0
    np.testing.assert_array_equal(pts, jcamera.Checkerboard(rows=3, cols=4, square_size=2.0).object_points())


def _board_image(cam, rvec, tvec, rows=6, cols=9, square=1.0, size=(480, 640)):
    """A rendered checkerboard of (rows + 1) x (cols + 1) squares seen by
    `cam` at pose (rvec, tvec): each square's corners projected, filled
    black or white."""
    img = np.full(size, 255, np.uint8)
    for i in range(-1, rows):
        for j in range(-1, cols):
            if (i + j) % 2:
                continue
            quad = np.array([[j, i, 0], [j + 1, i, 0], [j + 1, i + 1, 0], [j, i + 1, 0]], np.float64) * square
            px, _ = cv2.projectPoints(quad, rvec, tvec, cam.matrix, cam.distortion)
            cv2.fillConvexPoly(img, np.round(px.reshape(-1, 2) * 16).astype(np.int32), 0, lineType=cv2.LINE_AA,
                               shift=4)
    return img


@pytest.fixture
def one_cv2_thread():
    """cv2's calibration sums over its threads in any order; on one thread
    the same corners give the same bits in every run."""
    before = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        yield
    finally:
        cv2.setNumThreads(before)


def test_calibrator_recovers_the_camera_as_the_reference_does(one_cv2_thread):
    truth = tcamera.Camera(width=640, height=480)
    poses = [((0.3, -0.2, 0.1), (-4.0, -2.5, 22.0)), ((-0.25, 0.3, -0.05), (-4.5, -3.0, 20.0)),
             ((0.1, 0.35, 0.2), (-3.5, -2.0, 24.0)), ((-0.35, -0.1, 0.0), (-4.0, -3.5, 21.0)),
             ((0.2, 0.1, -0.3), (-5.0, -2.5, 23.0))]
    views = [_board_image(truth, np.array(r), np.array(t)) for r, t in poses]
    got, want = tcamera.Calibrator(), jcamera.Calibrator()
    for img in views:
        assert got.add_view(img) and want.add_view(img)
    assert got.num_views == want.num_views == len(views)
    cam, ref = got.calibrate(), want.calibrate()
    # the same cv2 calls on the same corners, on one thread: the same bits
    np.testing.assert_array_equal(cam.matrix, ref.matrix)
    np.testing.assert_array_equal(cam.distortion, ref.distortion)
    assert (cam.width, cam.height) == (640, 480)
    # and it is the camera the boards were rendered with, to within a pixel's share
    np.testing.assert_allclose(cam.matrix, truth.matrix, rtol=0.02, atol=3.0)
    # an image with no board adds no view; undistort keeps the shape
    assert not got.add_view(np.full((480, 640), 128, np.uint8)) and got.num_views == len(views)
    assert cam.undistort(views[0]).shape == views[0].shape


def test_without_cv2_the_paths_behave_as_the_references(monkeypatch):
    """The card machine may lack cv2: projection falls back to the pinhole
    formula, undistort returns its input, no corners are found and no
    calibration is made, as the reference does without it."""
    monkeypatch.setattr(tcamera, "_cv2", lambda: None)
    cam = tcamera.Camera(width=100, height=80)
    pts = np.array([[1.0, -2.0, 10.0], [0.5, 0.5, 4.0]])
    want = (cam.matrix @ np.concatenate([pts[:, :2] / pts[:, 2:], np.ones((2, 1))], 1).T).T[:, :2]
    np.testing.assert_allclose(cam.project(pts), want)
    img = np.zeros((80, 100), np.uint8)
    assert cam.undistort(img) is img
    assert tcamera.Checkerboard().find_corners(img) is None
    cal = tcamera.Calibrator()
    assert not cal.add_view(img) and cal.calibrate() is None
