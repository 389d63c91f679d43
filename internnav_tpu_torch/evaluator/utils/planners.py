"""Path planners over occupancy grids.

Reference surface (internnav/evaluator/utils/): `AStarPlanner` (continuous
grid A* with heading-change cost, continuous_planner.py:8-288),
`AStarDiscretePlanner` (action-space A* emitting forward/left/right plans,
discrete_planner.py:9-294), and the pixel↔world transforms +
plan_and_get_actions entry functions (path_plan.py:107,140). Used by the
S2+planner baselines (iPlanner rows in BASELINE.md) and visualization.

Copy of internnav_tpu/evaluator/utils/planners.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ------------------------------------------------------- grid <-> world
def world_to_grid(xy: Sequence[float], origin: Sequence[float],
                  resolution: float) -> Tuple[int, int]:
    return (int(round((xy[0] - origin[0]) / resolution)),
            int(round((xy[1] - origin[1]) / resolution)))


def grid_to_world(ij: Sequence[int], origin: Sequence[float],
                  resolution: float) -> Tuple[float, float]:
    return (origin[0] + ij[0] * resolution, origin[1] + ij[1] * resolution)


def inflate_obstacles(occupancy: np.ndarray, radius_cells: int) -> np.ndarray:
    """Binary dilation by a disc (the reference's dilation structure,
    evaluator/utils/common.py:28)."""
    if radius_cells <= 0:
        return occupancy.astype(bool)
    occ = occupancy.astype(bool)
    H, W = occ.shape
    out = occ.copy()
    ys, xs = np.nonzero(occ)
    for dy in range(-radius_cells, radius_cells + 1):
        for dx in range(-radius_cells, radius_cells + 1):
            if dy * dy + dx * dx > radius_cells * radius_cells:
                continue
            y2 = np.clip(ys + dy, 0, H - 1)
            x2 = np.clip(xs + dx, 0, W - 1)
            out[y2, x2] = True
    return out


# ------------------------------------------------------------ continuous A*
_N8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


class AStarPlanner:
    """8-connected grid A* with an angle-change cost term (reference
    continuous_planner.py: angle cost discourages zig-zag paths)."""

    def __init__(self, occupancy: np.ndarray, origin=(0.0, 0.0),
                 resolution: float = 0.1, angle_cost: float = 0.2,
                 inflate_radius_m: float = 0.0):
        r = int(round(inflate_radius_m / resolution))
        self.occ = inflate_obstacles(occupancy, r)
        self.origin = np.asarray(origin, np.float64)
        self.resolution = resolution
        self.angle_cost = angle_cost

    def plan(self, start_xy, goal_xy, max_expansions: int = 200000
             ) -> Optional[np.ndarray]:
        """→ (K, 2) world-frame waypoints or None when unreachable."""
        H, W = self.occ.shape
        start = world_to_grid(start_xy, self.origin, self.resolution)
        goal = world_to_grid(goal_xy, self.origin, self.resolution)
        if not (0 <= start[0] < H and 0 <= start[1] < W):
            return None
        if not (0 <= goal[0] < H and 0 <= goal[1] < W) or self.occ[goal]:
            return None

        def h(n):
            return np.hypot(n[0] - goal[0], n[1] - goal[1])

        open_q: List = [(h(start), 0.0, start, None)]
        came: Dict = {}
        g_cost = {start: 0.0}
        expansions = 0
        while open_q and expansions < max_expansions:
            _, g, node, parent_dir = heapq.heappop(open_q)
            if node == goal:
                path = [node]
                while path[-1] in came:
                    path.append(came[path[-1]][0])
                path.reverse()
                return np.asarray(
                    [grid_to_world(p, self.origin, self.resolution) for p in path]
                )
            expansions += 1
            for d in _N8:
                nxt = (node[0] + d[0], node[1] + d[1])
                if not (0 <= nxt[0] < H and 0 <= nxt[1] < W) or self.occ[nxt]:
                    continue
                step = np.hypot(*d)
                turn = 0.0
                if parent_dir is not None and parent_dir != d:
                    turn = self.angle_cost
                ng = g + step + turn
                if ng < g_cost.get(nxt, np.inf):
                    g_cost[nxt] = ng
                    came[nxt] = (node, d)
                    heapq.heappush(open_q, (ng + h(nxt), ng, nxt, d))
        return None


# ------------------------------------------------------------- discrete A*
class AStarDiscretePlanner:
    """A* over (cell, heading) states with VLN actions forward/left/right
    (reference discrete_planner.py: plans directly in action space)."""

    def __init__(self, occupancy: np.ndarray, origin=(0.0, 0.0),
                 resolution: float = 0.1, step_m: float = 0.25,
                 turn_deg: float = 15.0):
        self.occ = occupancy.astype(bool)
        self.origin = np.asarray(origin, np.float64)
        self.resolution = resolution
        self.step = step_m
        self.turn = np.deg2rad(turn_deg)
        self.n_headings = int(round(2 * np.pi / self.turn))

    def _blocked(self, xy) -> bool:
        i, j = world_to_grid(xy, self.origin, self.resolution)
        H, W = self.occ.shape
        return not (0 <= i < H and 0 <= j < W) or bool(self.occ[i, j])

    def plan(self, start_xy, start_yaw: float, goal_xy,
             goal_radius: float = 0.25, max_expansions: int = 100000
             ) -> Optional[List[int]]:
        """→ action list [1=fwd, 2=left, 3=right] reaching goal_radius."""
        goal = np.asarray(goal_xy, np.float64)
        h0 = int(round(start_yaw / self.turn)) % self.n_headings

        def key(xy, hd):
            return (*world_to_grid(xy, self.origin, self.resolution), hd)

        start_state = (tuple(np.asarray(start_xy, np.float64)), h0)
        open_q: List = [(np.linalg.norm(np.asarray(start_xy) - goal) / self.step,
                         0.0, start_state, [])]
        seen = set()
        expansions = 0
        while open_q and expansions < max_expansions:
            _, g, (xy, hd), plan = heapq.heappop(open_q)
            if np.linalg.norm(np.asarray(xy) - goal) <= goal_radius:
                return plan
            k = key(xy, hd)
            if k in seen:
                continue
            seen.add(k)
            expansions += 1
            yaw = hd * self.turn
            fwd = (xy[0] + self.step * np.cos(yaw), xy[1] + self.step * np.sin(yaw))
            cands = []
            if not self._blocked(fwd):
                cands.append((fwd, hd, 1))
            cands.append((xy, (hd + 1) % self.n_headings, 2))
            cands.append((xy, (hd - 1) % self.n_headings, 3))
            for nxy, nhd, act in cands:
                nk = key(nxy, nhd)
                if nk in seen:
                    continue
                ng = g + 1.0
                hcost = np.linalg.norm(np.asarray(nxy) - goal) / self.step
                heapq.heappush(open_q, (ng + hcost, ng, (nxy, nhd), plan + [act]))
        return None


def plan_and_get_actions_discrete(occupancy, start_xy, start_yaw, goal_xy,
                                  **kwargs) -> Optional[List[int]]:
    """Reference path_plan.py:107 entry function."""
    return AStarDiscretePlanner(occupancy, **kwargs).plan(start_xy, start_yaw, goal_xy)


def plan_and_get_actions_continuous(occupancy, start_xy, goal_xy, **kwargs):
    """Reference path_plan.py:140 entry function → waypoint path."""
    return AStarPlanner(occupancy, **kwargs).plan(start_xy, goal_xy)
