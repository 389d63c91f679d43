"""MP3D ground-truth perception helpers for the dialog (VL-LN) stack.

Reference parity: internnav/env/utils/dialog_mp3d.py — `fill_small_holes`
(contour-area hole filling on depth/semantic maps, :5-36) and
`MP3DGTPerception` (:38-111): project MP3D object 3D bounding boxes into
the current camera view to produce per-target semantic masks, by lifting
the depth image to a point cloud, transforming to the PLY/world frame,
box-testing, and splatting the in-box points back to image coordinates.

All pure numpy/cv2 — runs host-side in the dialog evaluator loop.

Copy of internnav_tpu/dialog/mp3d.py, kept in the port so that it imports
nothing of the JAX package (held equal to it by tests/test_torch_dialog.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def fill_small_holes(depth_img: np.ndarray, area_thresh: int) -> np.ndarray:
    """Fill 0-valued regions smaller than area_thresh with 1 (reference
    :5-36)."""
    import cv2

    binary = np.where(depth_img == 0, 1, 0).astype("uint8")
    contours, _ = cv2.findContours(binary, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    filled = np.zeros_like(binary)
    for cnt in contours:
        if cv2.contourArea(cnt) < area_thresh:
            cv2.drawContours(filled, [cnt], 0, 1, -1)
    return np.where(filled == 1, 1, depth_img)


def get_point_cloud(depth_image: np.ndarray, mask: np.ndarray,
                    fx: float, fy: float) -> np.ndarray:
    """Pixels under mask → camera-frame (x, y, z) points (reference
    get_point_cloud)."""
    v, u = np.where(mask)
    z = depth_image[v, u]
    x = (u - depth_image.shape[1] // 2) * z / fx
    y = (v - depth_image.shape[0] // 2) * z / fy
    return np.stack([x, y, z], axis=-1)


def transform_points(tf: np.ndarray, points: np.ndarray) -> np.ndarray:
    hom = np.hstack([points, np.ones((points.shape[0], 1))])
    out = (tf @ hom.T).T
    return out[:, :3] / out[:, 3:]


def inverse_transform_points(tf: np.ndarray, points: np.ndarray) -> np.ndarray:
    return transform_points(np.linalg.inv(tf), points)


def project_points_to_image(points: np.ndarray, fx: float, fy: float,
                            shape) -> np.ndarray:
    """Camera-frame points → integer (row, col) image coords, clipped."""
    z = np.clip(points[:, 2], 1e-6, None)
    u = points[:, 0] * fx / z + shape[1] // 2
    v = points[:, 1] * fy / z + shape[0] // 2
    coords = np.stack([v, u], axis=-1).astype(np.int64)
    coords[:, 0] = np.clip(coords[:, 0], 0, shape[0] - 1)
    coords[:, 1] = np.clip(coords[:, 1], 0, shape[1] - 1)
    return coords


class MP3DGTPerception:
    """Per-target semantic masks from MP3D 3D bounding boxes (reference
    MP3DGTPerception.predict :55-111)."""

    def __init__(self, max_depth: float, min_depth: float, fx: float, fy: float):
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.fx = fx
        self.fy = fy

    def predict(self, depth: np.ndarray, targets: np.ndarray,
                tf_camera_to_ply: np.ndarray,
                area_threshold: int = 2500) -> np.ndarray:
        """depth (H, W) normalized [0, 1]; targets (N, 6) world-frame AABBs
        [min_xyz, max_xyz]; tf_camera_to_ply 4x4. → (N, H, W) uint8 masks."""
        filled = fill_small_holes(depth, area_threshold)
        scaled = filled * (self.max_depth - self.min_depth) + self.min_depth
        valid = scaled < self.max_depth
        pc_cam = get_point_cloud(scaled, valid, self.fx, self.fy)
        pc_ply = transform_points(tf_camera_to_ply, pc_cam) if len(pc_cam) \
            else pc_cam

        masks = []
        for target in np.atleast_2d(targets):
            sem = np.zeros(depth.shape, np.uint8)
            if len(pc_ply):
                lo, hi = target[:3], target[3:]
                in_box = np.all((pc_ply >= lo) & (pc_ply <= hi), axis=1)
                pts = pc_ply[in_box]
                if len(pts):
                    cam_pts = inverse_transform_points(tf_camera_to_ply, pts)
                    coords = project_points_to_image(cam_pts, self.fx, self.fy,
                                                     depth.shape)
                    sem[coords[:, 0], coords[:, 1]] = 1
                    sem = fill_small_holes(sem, area_threshold)
            masks.append(sem)
        if not masks:
            return np.zeros((1,) + depth.shape, np.uint8)
        return np.stack(masks, axis=0).astype(np.uint8)
