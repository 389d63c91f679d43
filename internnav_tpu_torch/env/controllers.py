"""Action controllers: how a discrete VLN action becomes robot motion.

Reference parity (internnav/env/utils/internutopia_extension/controllers/):
- DiscreteController (discrete_controller.py:12-94): Habitat-like actions
  executed as speed commands over steps_per_action physics substeps
  (0 stop / 1 forward 0.25 m / 2 left 15° / 3 right 15°);
- VlnMoveByFlashController (h1_vln_move_by_flash_controller.py:13-135):
  teleport directly to the post-action pose;
- VlnMoveByFlashCollisionController: teleport + collision check;
- StandStillController: hold pose for warm-up steps;
- H1VlnMoveBySpeedController: RL loco policy — stays simulator-side; the
  speed-command interface here is what it consumes.

Controllers are pure pose-update functions usable by any host-side env
backend (FakeEnv uses flash; a physics backend integrates substeps).

Copy of internnav_tpu/env/controllers.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

Pose = np.ndarray  # (x, y, yaw)

STOP, FORWARD, LEFT, RIGHT = 0, 1, 2, 3


@dataclass
class FlashController:
    """Teleport to the post-action pose (one macro step = one update)."""

    forward_distance: float = 0.25
    rotation_angle_deg: float = 15.0

    def apply(self, pose: Pose, action: int) -> Tuple[Pose, bool]:
        x, y, yaw = map(float, pose)
        a = int(action)
        if a == FORWARD:
            x += self.forward_distance * np.cos(yaw)
            y += self.forward_distance * np.sin(yaw)
        elif a == LEFT:
            yaw += np.deg2rad(self.rotation_angle_deg)
        elif a == RIGHT:
            yaw -= np.deg2rad(self.rotation_angle_deg)
        return np.asarray([x, y, yaw]), True  # finish_action always


@dataclass
class FlashCollisionController(FlashController):
    """Flash + collision check: the move is rejected when the target (or
    the midpoint) is occupied (reference VlnMoveByFlashCollisionController)."""

    is_occupied: Optional[Callable[[float, float], bool]] = None

    def apply(self, pose: Pose, action: int) -> Tuple[Pose, bool]:
        new_pose, done = super().apply(pose, action)
        if int(action) == FORWARD and self.is_occupied is not None:
            mid = (np.asarray(pose[:2]) + new_pose[:2]) / 2
            if self.is_occupied(*new_pose[:2]) or self.is_occupied(*mid):
                return np.asarray(pose, np.float64), True  # blocked: stay
        return new_pose, True


@dataclass
class DiscreteSpeedController:
    """Physical mode: the action becomes a (v, w) speed command integrated
    over steps_per_action substeps at physics_frequency Hz (reference
    DiscreteController). `finish_action` goes True on the last substep —
    the env's action-atomicity contract (vln_eval_task.py:131-216)."""

    forward_distance: float = 0.25
    rotation_angle_deg: float = 15.0
    steps_per_action: int = 50
    physics_frequency: int = 200
    _remaining: int = 0
    _cmd: Tuple[float, float] = (0.0, 0.0)

    def start(self, action: int) -> None:
        dt_total = self.steps_per_action / self.physics_frequency
        a = int(action)
        if a == FORWARD:
            self._cmd = (self.forward_distance / dt_total, 0.0)
        elif a == LEFT:
            self._cmd = (0.0, np.deg2rad(self.rotation_angle_deg) / dt_total)
        elif a == RIGHT:
            self._cmd = (0.0, -np.deg2rad(self.rotation_angle_deg) / dt_total)
        else:
            self._cmd = (0.0, 0.0)
        self._remaining = self.steps_per_action

    def substep(self, pose: Pose) -> Tuple[Pose, Tuple[float, float], bool]:
        """One physics substep → (new pose, (v, w) command, finish_action)."""
        if self._remaining <= 0:
            return np.asarray(pose, np.float64), (0.0, 0.0), True
        v, w = self._cmd
        dt = 1.0 / self.physics_frequency
        x, y, yaw = map(float, pose)
        x += v * np.cos(yaw) * dt
        y += v * np.sin(yaw) * dt
        yaw += w * dt
        self._remaining -= 1
        return np.asarray([x, y, yaw]), (v, w), self._remaining == 0

    def apply(self, pose: Pose, action: int) -> Tuple[Pose, bool]:
        """Run all substeps at once (kinematic backends)."""
        self.start(action)
        p = np.asarray(pose, np.float64)
        done = self._remaining == 0
        while not done:
            p, _, done = self.substep(p)
        return p, True


@dataclass
class StandStillController:
    """Hold pose (warm-up steps; reference StandStillController)."""

    def apply(self, pose: Pose, action: int = STOP) -> Tuple[Pose, bool]:
        return np.asarray(pose, np.float64), True


def build_controller(kind: str, **kwargs):
    """Factory keyed like the reference controller configs."""
    kinds = {
        "flash": FlashController,
        "flash_collision": FlashCollisionController,
        "discrete": DiscreteSpeedController,
        "speed": DiscreteSpeedController,
        "stand_still": StandStillController,
    }
    if kind not in kinds:
        raise KeyError(f"unknown controller {kind!r}; known: {sorted(kinds)}")
    return kinds[kind](**kwargs)
