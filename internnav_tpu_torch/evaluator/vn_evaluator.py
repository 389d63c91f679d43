"""VN (visual navigation) pointgoal benchmark evaluator.

Reference parity: the VN benchmark harness behind BASELINE.md's
ClutteredEnv / InternScenes rows (NavDP vs iPlanner/ViPlanner SR/SPL):
pointgoal episodes in obstacle scenes, success when the agent stops (or
times out) within the success radius, SPL against the geodesic distance.
The kinematic backend integrates the agent's waypoint/velocity outputs
with obstacle collision checks (grid occupancy), replacing Isaac physics.

Copy of internnav_tpu/evaluator/vn_evaluator.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from internnav_tpu_torch.configs.evaluator import EvalCfg
from internnav_tpu_torch.env.fake_env import procedural_frame
from internnav_tpu_torch.evaluator.base import Evaluator
from internnav_tpu_torch.utils.geometry import wrap_angle


@dataclass
class VNEpisode:
    episode_id: str
    start_xy: np.ndarray
    goal_xy: np.ndarray
    occupancy: Optional[np.ndarray] = None  # (H, W) bool grid @ resolution
    resolution: float = 0.1
    origin: np.ndarray = field(default_factory=lambda: np.zeros(2))
    geodesic: Optional[float] = None

    def blocked(self, xy) -> bool:
        if self.occupancy is None:
            return False
        i = int(round((xy[0] - self.origin[0]) / self.resolution))
        j = int(round((xy[1] - self.origin[1]) / self.resolution))
        H, W = self.occupancy.shape
        if not (0 <= i < H and 0 <= j < W):
            return False
        return bool(self.occupancy[i, j])


def make_cluttered_episodes(n: int = 8, size_m: float = 6.0,
                            n_obstacles: int = 10, seed: int = 0) -> List[VNEpisode]:
    """Procedural cluttered-scene episodes (the ClutteredEnv analogue)."""
    rs = np.random.RandomState(seed)
    eps = []
    cells = int(size_m / 0.1)
    for i in range(n):
        occ = np.zeros((cells, cells), bool)
        for _ in range(n_obstacles):
            ci, cj = rs.randint(5, cells - 5, 2)
            r = rs.randint(2, 5)
            occ[max(ci - r, 0): ci + r, max(cj - r, 0): cj + r] = True
        start = np.asarray([0.5, size_m / 2])
        goal = np.asarray([size_m - 0.5, size_m / 2 + rs.uniform(-1, 1)])
        # keep start/goal clear
        si, sj = int(start[0] / 0.1), int(start[1] / 0.1)
        gi, gj = int(goal[0] / 0.1), int(goal[1] / 0.1)
        occ[max(si - 4, 0): si + 4, max(sj - 4, 0): sj + 4] = False
        occ[max(gi - 4, 0): gi + 4, max(gj - 4, 0): gj + 4] = False
        eps.append(VNEpisode(episode_id=str(i), start_xy=start, goal_xy=goal,
                             occupancy=occ, geodesic=float(np.linalg.norm(goal - start))))
    return eps


@Evaluator.register("vn_pointgoal")
class VNPointGoalEvaluator(Evaluator):
    def __init__(self, cfg: EvalCfg, episodes: Optional[List[VNEpisode]] = None,
                 **kwargs):
        self.episodes = episodes if episodes is not None else make_cluttered_episodes()
        self.success_radius = float(cfg.eval_settings.get("success_radius", 0.5))
        self.max_steps = cfg.task.max_step
        self.rgb_hw = tuple(cfg.env.env_settings.get("rgb_resolution", [224, 224]))
        kwargs.setdefault("env", _Null())
        super().__init__(cfg, **kwargs)

    def _obs(self, ep: VNEpisode, pose: np.ndarray) -> Dict[str, Any]:
        rgb, depth = procedural_frame(pose, abs(hash(ep.episode_id)) % (2**31),
                                      *self.rgb_hw)
        # pointgoal in the agent frame
        d = ep.goal_xy - pose[:2]
        c, s = np.cos(-pose[2]), np.sin(-pose[2])
        local = np.asarray([c * d[0] - s * d[1], s * d[0] + c * d[1], 0.0])
        return {"rgb": rgb, "depth": depth, "pointgoal": local.astype(np.float32)}

    def eval_action(self) -> List[Dict[str, Any]]:
        results = []
        for ep in self.episodes:
            results.append(self._run_episode(ep))
        return results

    def _run_episode(self, ep: VNEpisode) -> Dict[str, Any]:
        self.agent.reset()
        pose = np.asarray([ep.start_xy[0], ep.start_xy[1], 0.0])
        tl = 0.0
        collided = False
        for _ in range(self.max_steps):
            out = self.agent.step([self._obs(ep, pose)])[0]
            wp = np.asarray(out.get("waypoint", [0.1, 0.0, 0.0]))
            # body-frame waypoint → world
            c, s = np.cos(pose[2]), np.sin(pose[2])
            step_xy = np.asarray([c * wp[0] - s * wp[1], s * wp[0] + c * wp[1]])
            new_xy = pose[:2] + step_xy
            if ep.blocked(new_xy):
                collided = True
                break
            tl += float(np.linalg.norm(step_xy))
            pose = np.asarray([new_xy[0], new_xy[1],
                               wrap_angle(pose[2] + wp[2])])
            if np.linalg.norm(pose[:2] - ep.goal_xy) < self.success_radius:
                break
        ne = float(np.linalg.norm(pose[:2] - ep.goal_xy))
        success = float(ne < self.success_radius and not collided)
        geo = ep.geodesic or float(np.linalg.norm(ep.goal_xy - ep.start_xy))
        return {
            "episode_id": ep.episode_id,
            "split": "vn",
            "success": success,
            "spl": success * geo / max(tl, geo) if tl > 0 else 0.0,
            "osr": success,
            "NE": ne,
            "TL": tl,
            "ndtw": 0.0,
            "steps": float(self.max_steps),
            "collided": float(collided),
        }


class _Null:
    is_running = True

    def close(self):
        pass
