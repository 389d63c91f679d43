"""Planar geometry helpers (numpy).

The part of internnav_tpu/utils/geometry.py that the port uses, copied so
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
