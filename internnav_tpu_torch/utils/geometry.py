"""Planar geometry helpers (numpy).

The part of internnav_tpu/utils/geometry.py that the port uses (the planar
frame helpers and the pinhole camera unprojection), copied so
that the port imports nothing of the JAX package. World positions are
(x, y) in the ground plane, yaw counter-clockwise from +x.
"""

from __future__ import annotations

import numpy as np


def yaw_rotmat(yaw: float) -> np.ndarray:
    """2x2 rotation matrix for a scalar yaw."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s], [s, c]], dtype=np.float64)


def to_local_coords(positions: np.ndarray, curr_pos: np.ndarray, curr_yaw: float) -> np.ndarray:
    """World → robot-local frame: translate by -curr_pos, rotate by -curr_yaw."""
    rot = yaw_rotmat(curr_yaw)
    return (np.asarray(positions) - np.asarray(curr_pos)) @ rot  # R(-yaw) = R(yaw)^T applied on the right


def wrap_angle(a):
    """Wrap to (-pi, pi]."""
    return (a + np.pi) % (2 * np.pi) - np.pi


# ------------------------------------------------------------ camera geometry
def camera_intrinsics(width: int, height: int, hfov_deg: float) -> np.ndarray:
    """Pinhole K from the horizontal field of view."""
    fx = (width / 2.0) / np.tan(np.radians(hfov_deg) / 2.0)
    fy = fx
    return np.array([[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1.0]])


def pixel_to_camera(pixel_uv: np.ndarray, depth: float, K: np.ndarray) -> np.ndarray:
    """Unproject a pixel at a metric depth into the camera frame."""
    u, v = pixel_uv
    x = (u - K[0, 2]) * depth / K[0, 0]
    y = (v - K[1, 2]) * depth / K[1, 1]
    return np.array([x, y, depth])


def pixel_to_world(pixel_uv: np.ndarray, depth: float, K: np.ndarray,
                   tf_camera_to_world: np.ndarray) -> np.ndarray:
    """Pixel + depth → world point through a 4x4 camera-to-world transform."""
    pc = np.append(pixel_to_camera(pixel_uv, depth, K), 1.0)
    return (tf_camera_to_world @ pc)[:3]
