"""Planar geometry helpers (numpy).

The part of internnav_tpu/utils/geometry.py that the port uses (the planar
frame helpers, the quaternion conversions of the VLN-PE env and its
checkers, and the pinhole camera unprojection), copied so that the port
imports nothing of the JAX package. World positions are
(x, y) in the ground plane, yaw counter-clockwise from +x.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- rotations
def yaw_from_quat_wxyz(q) -> float:
    """Yaw of a (w, x, y, z) quaternion."""
    w, x, y, z = (float(v) for v in np.asarray(q, np.float64).ravel()[:4])
    return float(np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)))


def quat_wxyz_from_yaw(yaw: float) -> np.ndarray:
    """Pure-yaw (w, x, y, z) quaternion (roll/pitch zero)."""
    return np.array([np.cos(yaw / 2.0), 0.0, 0.0, np.sin(yaw / 2.0)])


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


# ------------------------------------------------------------- quaternions
def quat_to_rot_matrix(quat: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion → 3x3 rotation."""
    w, x, y, z = np.asarray(quat, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def rot_matrix_to_euler(mat: np.ndarray, degrees: bool = False) -> np.ndarray:
    """3x3 rotation → extrinsic xyz euler angles."""
    mat = np.asarray(mat, dtype=np.float64)
    sy = np.sqrt(mat[0, 0] ** 2 + mat[1, 0] ** 2)
    if sy > 1e-6:
        roll = np.arctan2(mat[2, 1], mat[2, 2])
        pitch = np.arctan2(-mat[2, 0], sy)
        yaw = np.arctan2(mat[1, 0], mat[0, 0])
    else:  # gimbal lock
        roll = np.arctan2(-mat[1, 2], mat[1, 1])
        pitch = np.arctan2(-mat[2, 0], sy)
        yaw = 0.0
    out = np.array([roll, pitch, yaw])
    return np.degrees(out) if degrees else out


def quat_to_euler_angles(quat: np.ndarray, degrees: bool = False) -> np.ndarray:
    return rot_matrix_to_euler(quat_to_rot_matrix(quat), degrees=degrees)


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
