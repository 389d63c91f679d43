"""Trajectory visualization: per-step frame dumps + video assembly.

Reference parity: VisualizeUtil (internnav/evaluator/utils/
visualize_util.py:39-187 — frame saving per trajectory + ffmpeg video) and
the obs/action drawing helpers (common.py:199-546 — action arrows,
trajectory overlay, observation tiling). ffmpeg may be absent; video
assembly falls back to cv2.VideoWriter.

Copy of internnav_tpu/evaluator/utils/visualize.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

ACTION_NAMES = {0: "STOP", 1: "FORWARD", 2: "LEFT", 3: "RIGHT", 5: "LOOKDOWN"}


def draw_action(frame: np.ndarray, action: int,
                color=(255, 0, 0)) -> np.ndarray:
    """Overlay an action arrow/text (reference draw_action_with_image)."""
    import cv2

    img = np.ascontiguousarray(frame).copy()
    h, w = img.shape[:2]
    c = (w // 2, h - h // 6)
    L = h // 8
    if action == 1:
        cv2.arrowedLine(img, (c[0], c[1] + L // 2), (c[0], c[1] - L // 2), color, 2)
    elif action == 2:
        cv2.arrowedLine(img, (c[0] + L // 2, c[1]), (c[0] - L // 2, c[1]), color, 2)
    elif action == 3:
        cv2.arrowedLine(img, (c[0] - L // 2, c[1]), (c[0] + L // 2, c[1]), color, 2)
    cv2.putText(img, ACTION_NAMES.get(int(action), str(action)), (8, 24),
                cv2.FONT_HERSHEY_SIMPLEX, 0.7, color, 2)
    return img


def draw_trajectory_map(trajectory: Sequence, reference_path: Sequence,
                        size: int = 256, margin: float = 1.0) -> np.ndarray:
    """Top-down plot of executed vs reference path (reference
    draw_trajectory, common.py:199)."""
    import cv2

    img = np.full((size, size, 3), 255, np.uint8)
    pts = [np.asarray(p, np.float64)[:2] for p in list(reference_path) + list(trajectory)]
    if not pts:
        return img
    all_pts = np.stack(pts)
    lo = all_pts.min(0) - margin
    hi = all_pts.max(0) + margin
    scale = (size - 20) / max((hi - lo).max(), 1e-6)

    def to_px(p):
        q = (np.asarray(p[:2]) - lo) * scale + 10
        return int(q[0]), size - 1 - int(q[1])

    for seq, color in ((reference_path, (0, 180, 0)), (trajectory, (200, 0, 0))):
        seq = list(seq)
        for a, b in zip(seq[:-1], seq[1:]):
            cv2.line(img, to_px(a), to_px(b), color, 2)
    if len(reference_path):
        cv2.circle(img, to_px(reference_path[-1]), 5, (0, 0, 255), -1)
    return img


class VisualizeUtil:
    """Accumulates per-trajectory frames, writes pngs + assembles video."""

    def __init__(self, output_dir: str, fps: int = 10):
        self.output_dir = output_dir
        self.fps = fps
        self.frames: Dict[str, List[np.ndarray]] = {}

    def add_step(self, key: str, obs: Dict[str, Any], action: int) -> None:
        rgb = np.asarray(obs.get("rgb"))
        if rgb.ndim != 3:
            return
        self.frames.setdefault(key, []).append(draw_action(rgb.astype(np.uint8), action))

    def save_trajectory(self, key: str, reference_path=None, trajectory=None,
                        video: bool = True) -> Optional[str]:
        import cv2

        frames = self.frames.pop(key, [])
        if not frames:
            return None
        traj_dir = os.path.join(self.output_dir, key)
        os.makedirs(traj_dir, exist_ok=True)
        for i, f in enumerate(frames):
            cv2.imwrite(os.path.join(traj_dir, f"{i:04d}.png"),
                        cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        if reference_path is not None and trajectory is not None:
            cv2.imwrite(os.path.join(traj_dir, "map.png"),
                        draw_trajectory_map(trajectory, reference_path))
        if not video:
            return traj_dir
        out_path = os.path.join(self.output_dir, f"{key}.mp4")
        if not self._ffmpeg(traj_dir, out_path):
            self._cv2_video(frames, out_path)
        return out_path

    def _ffmpeg(self, frame_dir: str, out_path: str) -> bool:
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", str(self.fps), "-i",
                 os.path.join(frame_dir, "%04d.png"), "-pix_fmt", "yuv420p", out_path],
                check=True, capture_output=True, timeout=120,
            )
            return True
        except Exception:
            return False

    def _cv2_video(self, frames: List[np.ndarray], out_path: str) -> None:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             self.fps, (w, h))
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
