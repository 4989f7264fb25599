"""Intrinsic camera calibration (charuco + checkerboard).

The port's own copy of ros_vision_tpu/calib/intrinsic.py (host code, cv2).

Parity with the reference's camera_calibration package
(charuco_camera_calibrator.py:40-137, checkerboard_camera_calibrator.py:
38-156): DICT_4X4 charuco board detection requiring >= 8 corners, a capture
every 10th consecutive-detection frame up to 30 frames, cv2.calibrateCamera,
and a calibrationmatrix_<serial>.json artifact with camera_matrix /
distortion_coefficients / rms consumed at detector startup
(apriltags_cuda_detector.cu:315-371 / launch.load_calibration).
"""
from __future__ import annotations

import json
import logging
import os

import numpy as np

log = logging.getLogger(__name__)

MIN_CORNERS = 8
CAPTURE_EVERY = 10
MAX_FRAMES = 30


class CharucoCalibrator:
    def __init__(self, squares_x: int = 11, squares_y: int = 8,
                 square_len: float = 0.02, marker_len: float = 0.015,
                 max_frames: int = MAX_FRAMES):
        import cv2
        self.cv2 = cv2
        self.dictionary = cv2.aruco.getPredefinedDictionary(
            cv2.aruco.DICT_4X4_100)
        self.board = cv2.aruco.CharucoBoard(
            (squares_x, squares_y), square_len, marker_len, self.dictionary)
        self.detector = cv2.aruco.CharucoDetector(self.board)
        self.max_frames = max_frames
        self.captures = []           # (charuco_corners, charuco_ids)
        self._consecutive = 0
        self.image_size = None

    @property
    def n_captures(self) -> int:
        return len(self.captures)

    def process_frame(self, gray: np.ndarray) -> bool:
        """Returns True when the frame was captured for calibration."""
        self.image_size = gray.shape[::-1]
        corners, ids, _, _ = self.detector.detectBoard(gray)
        if corners is None or ids is None or len(ids) < MIN_CORNERS:
            self._consecutive = 0
            return False
        self._consecutive += 1
        if self._consecutive % CAPTURE_EVERY != 0:
            return False
        if len(self.captures) >= self.max_frames:
            return False
        self.captures.append((corners, ids))
        log.info("captured calibration frame %d/%d", len(self.captures),
                 self.max_frames)
        return True

    @property
    def ready(self) -> bool:
        return len(self.captures) >= self.max_frames

    def calibrate(self) -> dict:
        cv2 = self.cv2
        obj_pts, img_pts = [], []
        for corners, ids in self.captures:
            o, i = self.board.matchImagePoints(corners, ids)
            if o is not None and len(o) >= 4:
                obj_pts.append(o)
                img_pts.append(i)
        rms, mtx, dist, _, _ = cv2.calibrateCamera(
            obj_pts, img_pts, self.image_size, None, None)
        return {"camera_matrix": mtx.tolist(),
                "distortion_coefficients": dist.tolist(),
                "rms": float(rms)}


class CheckerboardCalibrator:
    def __init__(self, cols: int = 9, rows: int = 6,
                 square_len: float = 0.025, max_frames: int = MAX_FRAMES):
        import cv2
        self.cv2 = cv2
        self.pattern = (cols, rows)
        objp = np.zeros((cols * rows, 3), np.float32)
        objp[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2) * square_len
        self.objp = objp
        self.max_frames = max_frames
        self.obj_pts = []
        self.img_pts = []
        self._consecutive = 0
        self.image_size = None

    @property
    def n_captures(self) -> int:
        return len(self.img_pts)

    def process_frame(self, gray: np.ndarray) -> bool:
        cv2 = self.cv2
        self.image_size = gray.shape[::-1]
        found, corners = cv2.findChessboardCorners(gray, self.pattern)
        if not found:
            self._consecutive = 0
            return False
        self._consecutive += 1
        if self._consecutive % CAPTURE_EVERY != 0 or \
                len(self.img_pts) >= self.max_frames:
            return False
        corners = cv2.cornerSubPix(
            gray, corners, (11, 11), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3))
        self.obj_pts.append(self.objp)
        self.img_pts.append(corners)
        return True

    @property
    def ready(self) -> bool:
        return len(self.img_pts) >= self.max_frames

    def calibrate(self) -> dict:
        rms, mtx, dist, _, _ = self.cv2.calibrateCamera(
            self.obj_pts, self.img_pts, self.image_size, None, None)
        return {"camera_matrix": mtx.tolist(),
                "distortion_coefficients": dist.tolist(),
                "rms": float(rms)}


def write_calibration(result: dict, serial: str, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"calibrationmatrix_{serial}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return path
