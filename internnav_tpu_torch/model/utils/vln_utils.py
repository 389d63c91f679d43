"""VLN utility functions + S1/S2 dataclasses (host-side numpy).

Copy of internnav_tpu/model/utils/vln_utils.py (no torch, no jax), kept in
the port so that it imports nothing of the JAX package.

Parity targets in reference internnav/model/utils/vln_utils.py:
- split_and_clean (:19): split prompt on <image> placeholders;
- chunk_token (:36): per-step Δ(x, yaw) → discrete action (stop/↑/←/→);
- traj_to_actions (:63): sampled trajectories → mean path → lookahead
  controller producing forward/left/right action strings;
- S1Input/S1Output/S2Input/S2Output (:140-177).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np


def split_and_clean(text: str) -> List[str]:
    parts = re.split(r"(<image>)", text)
    out = []
    for part in parts:
        if part == "<image>":
            out.append(part)
        else:
            clean = part.replace("\n", "").strip()
            if clean:
                out.append(clean)
    return out


def chunk_token(dp_actions: np.ndarray) -> List[int]:
    """(T, 3) per-step deltas → discrete actions (reference :36-58)."""
    out = []
    for xyyaw in np.asarray(dp_actions, dtype=np.float64):
        x, yaw = xyyaw[0], xyyaw[-1]
        x_prop = abs(x / 0.25)
        yaw_prop = abs(yaw * 12 / np.pi)
        if x < 0.05 and abs(yaw) < 0.05:
            out.append(0)
        elif x_prop >= yaw_prop:
            out.append(1)
        elif yaw < 0:
            out.append(3)
        else:
            out.append(2)
    return out


def _normalize_angle(a: float) -> float:
    return (a + np.pi) % (2 * np.pi) - np.pi


def trajectory_to_discrete_actions(
    trajectory: np.ndarray, step_size: float = 0.25, turn_angle_deg: float = 15.0,
    lookahead: int = 4, max_actions: int = 64,
) -> List[int]:
    """Lookahead path follower (reference traj_to_actions inner fn :84-125)."""
    actions: List[int] = []
    yaw = 0.0
    pos = np.asarray(trajectory[0], dtype=np.float64)
    goal = np.asarray(trajectory[-1], dtype=np.float64)
    turn = np.deg2rad(turn_angle_deg)
    traj = np.asarray(trajectory, dtype=np.float64)
    while np.linalg.norm(pos - goal) > 0.2 and len(actions) < max_actions:
        dists = np.linalg.norm(traj - pos, axis=1)
        target = traj[min(int(np.argmin(dists)) + lookahead, len(traj) - 1)]
        d = target - pos
        if np.linalg.norm(d) < 1e-6:
            break
        delta_yaw = _normalize_angle(np.arctan2(d[1], d[0]) - yaw)
        n_turns = int(round(delta_yaw / turn))
        if n_turns > 0:
            actions += [2] * n_turns
        elif n_turns < 0:
            actions += [3] * (-n_turns)
        yaw = _normalize_angle(yaw + n_turns * turn)
        next_pos = pos + step_size * np.array([np.cos(yaw), np.sin(yaw)])
        if np.linalg.norm(next_pos - goal) > np.linalg.norm(pos - goal):
            break
        actions.append(1)
        pos = next_pos
    return actions


def traj_to_actions(dp_actions: np.ndarray, use_discrete_action: bool = True):
    """Sampled per-step deltas (S, T, 3) → discrete actions via the mean
    trajectory (reference :63-138; dx,dy scaled by 1/4)."""
    dp = np.array(dp_actions, dtype=np.float64)
    dp[:, :, :2] /= 4.0
    cums = np.cumsum(dp[:, :, :2], axis=1)  # (S, T, 2)
    S, T, _ = cums.shape
    xy = np.zeros((S, T + 1, 2))
    xy[:, 1:] = cums
    trajectory = xy.mean(axis=0)
    if use_discrete_action:
        return trajectory_to_discrete_actions(trajectory)
    return trajectory


def parse_actions(text: str) -> List[int]:
    """Arrow/STOP tokens → discrete actions (reference
    internvla_n1_policy.py:78-85 regex branch)."""
    mapping = {"STOP": 0, "↑": 1, "←": 2, "→": 3, "↓": 5}
    out = []
    for tok in re.findall(r"STOP|↑|←|→|↓", text):
        out.append(mapping[tok])
    return out


@dataclass
class S2Input:
    rgb: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    pose: Optional[np.ndarray] = None
    instruction: str = ""
    look_down: bool = False
    idx: int = -1


@dataclass
class S2Output:
    output_pixel: Optional[np.ndarray] = None
    output_action: Optional[List[int]] = None
    output_latent: Optional[Any] = None
    idx: int = -1

    def validate(self) -> bool:
        return (
            self.output_pixel is not None
            or self.output_action is not None
            or self.output_latent is not None
        )


@dataclass
class S1Input:
    rgb: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    latent: Optional[Any] = None


@dataclass
class S1Output:
    idx: List[int] = field(default_factory=list)
    trajectory: Optional[np.ndarray] = None
