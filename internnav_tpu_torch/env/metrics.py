"""Navigation metrics.

Parity targets:
- VLN-PE per-episode accumulator (reference internutopia_extension/metrics/
  vln_pe_metrics.py:10-118): NE, success (< success_distance), OSR, TL,
  SPL, steps, fail_reason, and the "simplified nDTW" (mean Gaussian
  proximity of the predicted trajectory to the nearest reference point,
  vln_pe_metrics.py:36-56).
- Habitat-style measures (habitat_extensions/vln/measures.py:20-203):
  PathLength, OracleNavigationError, OracleSuccess, OracleSPL, StepsTaken,
  and the true DTW-based nDTW (exp(-DTW / (len(gt) * 3))).

Copy of internnav_tpu/env/metrics.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


def euclidean(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)))


def dtw_distance(path: Sequence, ref: Sequence) -> float:
    """Classic O(N*M) dynamic-time-warping distance with euclidean cost
    (replaces the C `dtw` package used at measures.py:150)."""
    P, R = len(path), len(ref)
    if P == 0 or R == 0:
        return float("inf")
    path = np.asarray(path, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    # pairwise cost matrix, vectorized
    cost = np.linalg.norm(path[:, None, :] - ref[None, :, :], axis=-1)
    acc = np.full((P + 1, R + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, P + 1):
        m = np.minimum.accumulate  # noqa: F841 (kept simple; inner loop is small)
        for j in range(1, R + 1):
            acc[i, j] = cost[i - 1, j - 1] + min(acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1])
    return float(acc[P, R])


def ndtw(path: Sequence, ref: Sequence, threshold: float = 3.0) -> float:
    """True nDTW (arXiv:1907.05446; reference measures.py:199-203)."""
    if len(path) == 0 or len(ref) == 0:
        return 0.0
    return float(np.exp(-dtw_distance(path, ref) / (len(ref) * threshold)))


def simplified_ndtw(path: Sequence, ref: Sequence, threshold: float = 3.0) -> float:
    """VLN-PE's Gaussian-proximity variant (vln_pe_metrics.py:36-56):
    mean over trajectory points of exp(-d_min^2 / (2*thr^2))."""
    if len(path) == 0:
        return 0.0
    path = np.asarray(path, dtype=np.float64)[:, :2]
    ref = np.asarray(ref, dtype=np.float64)[:, :2]
    d = np.linalg.norm(path[:, None, :] - ref[None, :, :], axis=-1).min(axis=1)
    return float(np.mean(np.exp(-(d**2) / (2 * threshold**2))))


@dataclass
class VLNPEMetrics:
    """Per-episode accumulator with the VLN-PE semantics.

    Positions are (x, y[, z]); only x,y are used for distances
    (vln_pe_metrics.py:70-86).
    """

    reference_path: np.ndarray
    geodesic_distance: float
    success_distance: float = 3.0
    episode_id: str = ""
    trajectory_id: str = ""
    path_key: str = ""

    steps: int = 0
    path_length: float = 0.0
    ne: Optional[float] = None
    oracle_ne: float = field(default=float("inf"))
    trajectory: List[np.ndarray] = field(default_factory=list)
    fail_reason: str = ""
    prev_position: Optional[np.ndarray] = None

    def start(self, position) -> None:
        """Record the episode start pose (not counted as a step)."""
        position = np.asarray(position, dtype=np.float64)
        self.trajectory.append(position)
        self.prev_position = position

    def update(self, position, finish_action: bool = True, fail_reason: str = "") -> None:
        position = np.asarray(position, dtype=np.float64)
        if fail_reason:
            self.fail_reason = fail_reason
        self.steps += 1
        if self.prev_position is not None:
            self.path_length += euclidean(position[:2], self.prev_position[:2])
        else:
            self.trajectory.append(position)
        self.prev_position = position
        if finish_action:
            self.trajectory.append(position)
            goal = np.asarray(self.reference_path[-1], dtype=np.float64)
            self.ne = euclidean(position[:2], goal[:2])
            self.oracle_ne = min(self.oracle_ne, self.ne)

    def calc(self) -> Dict:
        ne = self.ne if self.ne is not None else float("inf")
        success = float(ne < self.success_distance)
        spl = (
            success * self.geodesic_distance / max(self.path_length, self.geodesic_distance)
            if self.path_length > 0
            else 0.0
        )
        return {
            "episode_id": self.episode_id,
            "trajectory_id": self.trajectory_id,
            "path_key": self.path_key,
            "shortest_path_length": self.geodesic_distance,
            "NE": ne,
            "success": success,
            "osr": float(self.oracle_ne < self.success_distance),
            "TL": self.path_length,
            "spl": spl,
            "ndtw": simplified_ndtw(
                np.asarray(self.trajectory), np.asarray(self.reference_path),
                self.success_distance,
            ),
            "steps": self.steps,
            "fail_reason": self.fail_reason,
        }


def aggregate_metrics(per_episode: List[Dict]) -> Dict[str, float]:
    """Mean SR/SPL/NE/OSR/TL/nDTW with NaN/inf cleanup (reference
    habitat_vln_evaluator.py:202-233)."""
    if not per_episode:
        return {}
    keys = ["success", "spl", "osr", "NE", "TL", "ndtw", "steps"]
    out = {}
    for k in keys:
        vals = np.asarray([m[k] for m in per_episode if k in m], dtype=np.float64)
        vals = vals[np.isfinite(vals)]
        out[k] = float(vals.mean()) if len(vals) else 0.0
    out["num_episodes"] = float(len(per_episode))
    return out
