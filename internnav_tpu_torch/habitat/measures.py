"""Habitat-style navigation measures as pure functions.

Reference parity: internnav/habitat_extensions/vln/measures.py:20-203 —
PathLength, OracleNavigationError, OracleSuccess (r=3.0), OracleSPL,
StepsTaken, NDTW (true DTW vs gt paths). Implemented over recorded
trajectories instead of habitat Measure classes so they run against any
env backend; `compute_all` returns the same metric dict keys the habitat
evaluator aggregates (habitat_vln_evaluator.py:202-233).

Copy of internnav_tpu/habitat/measures.py over the port's env/metrics.py
(held equal to it by tests/test_torch_habitat.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from internnav_tpu_torch.env.metrics import dtw_distance, euclidean, ndtw


def path_length(trajectory: Sequence) -> float:
    t = np.asarray(trajectory, np.float64)
    if len(t) < 2:
        return 0.0
    return float(np.linalg.norm(np.diff(t[:, :2], axis=0), axis=1).sum())


def navigation_error(trajectory: Sequence, goal) -> float:
    return euclidean(np.asarray(trajectory[-1])[:2], np.asarray(goal)[:2])


def oracle_navigation_error(trajectory: Sequence, goal) -> float:
    t = np.asarray(trajectory, np.float64)[:, :2]
    return float(np.linalg.norm(t - np.asarray(goal)[None, :2], axis=1).min())


def success(trajectory: Sequence, goal, radius: float = 3.0) -> float:
    return float(navigation_error(trajectory, goal) < radius)


def oracle_success(trajectory: Sequence, goal, radius: float = 3.0) -> float:
    return float(oracle_navigation_error(trajectory, goal) < radius)


def spl(trajectory: Sequence, goal, geodesic: float, radius: float = 3.0) -> float:
    s = success(trajectory, goal, radius)
    pl = path_length(trajectory)
    return s * geodesic / max(pl, geodesic) if pl > 0 else 0.0


def oracle_spl(trajectory: Sequence, goal, geodesic: float, radius: float = 3.0) -> float:
    s = oracle_success(trajectory, goal, radius)
    pl = path_length(trajectory)
    return s * geodesic / max(pl, geodesic) if pl > 0 else 0.0


def compute_all(trajectory: Sequence, reference_path: Sequence,
                geodesic: Optional[float] = None, radius: float = 3.0,
                gt_locations: Optional[Sequence] = None) -> Dict[str, float]:
    goal = np.asarray(reference_path[-1])
    if geodesic is None:
        geodesic = path_length(reference_path)
    gt = gt_locations if gt_locations is not None else reference_path
    return {
        "TL": path_length(trajectory),
        "NE": navigation_error(trajectory, goal),
        "oracle_ne": oracle_navigation_error(trajectory, goal),
        "success": success(trajectory, goal, radius),
        "osr": oracle_success(trajectory, goal, radius),
        "spl": spl(trajectory, goal, geodesic, radius),
        "oracle_spl": oracle_spl(trajectory, goal, geodesic, radius),
        "steps": float(max(len(trajectory) - 1, 0)),
        "ndtw": ndtw(np.asarray(trajectory)[:, :2], np.asarray(gt)[:, :2], radius),
    }
