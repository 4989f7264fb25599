"""Rotation helpers for camera extrinsics.

Functional parity with the reference's vision_utils rotation_utils
(rotation_utils.cpp:20-87): degree-based elementary rotations, XYZ
composition, and the camera->robot base transform camera_to_robot() =
Rx(-90) @ Ry(90) that maps the camera optical frame (z forward, x right,
y down) into the FRC robot frame (x forward, y left, z up).
"""
from __future__ import annotations

import numpy as np


def rot_x(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def rot_y(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def rot_z(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def compose_rotations_xyz(x_deg: float, y_deg: float,
                          z_deg: float) -> np.ndarray:
    """R = Rz @ Ry @ Rx (apply X first, then Y, then Z)."""
    return rot_z(z_deg) @ rot_y(y_deg) @ rot_x(x_deg)


def camera_to_robot() -> np.ndarray:
    """Base camera->robot rotation: Rx(-90) @ Ry(90)."""
    return rot_x(-90) @ rot_y(90)


def camera_mount_rotation(pitch_deg: float = 0.0,
                          yaw_deg: float = 0.0) -> np.ndarray:
    """Initial extrinsic rotation for a camera mounted with the given pitch
    (up positive) and yaw (counterclockwise positive) relative to robot
    forward (robot_rotations.py generator equivalent)."""
    return rot_z(yaw_deg) @ rot_y(-pitch_deg) @ camera_to_robot()
