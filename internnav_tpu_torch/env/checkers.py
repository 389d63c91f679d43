"""Episode failure detection: done / stuck / fall checks.

Reference parity (SURVEY.md §5.3):
- DoneChecker (internutopia_extension/tasks/utils.py:14-71): stop action,
  exceed-max-step, fall, stuck;
- StuckChecker (evaluator/utils/stuck_checker.py:6-39): < 0.2 m translation
  and < 15° rotation over a window of iterations;
- check_robot_fall (evaluator/utils/common.py:63): height below threshold
  or excessive tilt.

These run host-side in the env/evaluator loop; fail reasons flow into the
metrics and the resume store.

Copy of internnav_tpu/env/checkers.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from internnav_tpu_torch.utils.geometry import quat_to_euler_angles, wrap_angle


class StuckChecker:
    def __init__(self, window: int = 2500, min_translation: float = 0.2,
                 min_rotation_deg: float = 15.0):
        self.window = window
        self.min_translation = min_translation
        self.min_rotation = np.deg2rad(min_rotation_deg)
        self.reset(np.zeros(3), 0.0)

    def reset(self, position, yaw: float) -> None:
        self._anchor_pos = np.asarray(position, np.float64)
        self._anchor_yaw = float(yaw)
        self._count = 0

    def update(self, position, yaw: float) -> bool:
        """Returns True when stuck. Anchors reset whenever the robot moves."""
        position = np.asarray(position, np.float64)
        moved = np.linalg.norm(position[:2] - self._anchor_pos[:2]) > self.min_translation
        turned = abs(wrap_angle(yaw - self._anchor_yaw)) > self.min_rotation
        if moved or turned:
            self.reset(position, yaw)
            return False
        self._count += 1
        return self._count >= self.window


def check_robot_fall(position, rotation_quat, ankle_height: Optional[float] = None,
                     height_threshold: float = 0.5,
                     tilt_threshold_deg: float = 60.0) -> bool:
    """Fall = base below height threshold or roll/pitch beyond tilt
    (reference check_robot_fall semantics)."""
    z = float(np.asarray(position).ravel()[-1]) if ankle_height is None else ankle_height
    if z < height_threshold:
        return True
    roll, pitch, _ = quat_to_euler_angles(np.asarray(rotation_quat, np.float64))
    tilt = np.rad2deg(max(abs(roll), abs(pitch)))
    return tilt > tilt_threshold_deg


class DoneChecker:
    """Aggregates the episode-termination conditions into a fail_reason."""

    def __init__(self, max_step: int = 200, stuck_window: int = 2500,
                 check_fall: bool = True):
        self.max_step = max_step
        self.check_fall = check_fall
        self.stuck = StuckChecker(window=stuck_window)
        self.steps = 0

    def reset(self, position=np.zeros(3), yaw: float = 0.0) -> None:
        self.steps = 0
        self.stuck.reset(position, yaw)

    def update(self, action: int, position, yaw: float = 0.0,
               rotation_quat=None) -> Tuple[bool, str]:
        """→ (done, fail_reason); fail_reason empty on a clean stop."""
        self.steps += 1
        if action == 0:
            return True, ""
        if self.steps >= self.max_step:
            return True, "exceed_max_step"
        if self.check_fall and rotation_quat is not None and check_robot_fall(
            position, rotation_quat
        ):
            return True, "robot_fall"
        if self.stuck.update(position, yaw):
            return True, "robot_stuck"
        return False, ""
