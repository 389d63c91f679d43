"""habitat.Env → HabitatSimLike adapter + kinematic FakeSim.

The adapter wraps a real habitat environment (when installed) behind the
duck type HabitatVLNEvaluator drives (reference habitat wiring:
internnav/env/habitat_env.py:9-115 — scene-grouped episode iteration,
manual current_episode advance on reset). FakeSim provides the same
surface kinematically (FakeEnv physics) for tests and offline runs.

Copy of internnav_tpu/habitat/sim_adapter.py over the port's FakeEnv
physics and frames (held equal to it by tests/test_torch_habitat.py).
`HabitatSimAdapter` imports habitat when it is built, so it is held at
import level only where habitat is not installed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from internnav_tpu_torch.env.episodes import Episode
from internnav_tpu_torch.env.fake_env import FORWARD_DIST, TURN_RAD, procedural_frame


class FakeSim:
    """Kinematic single-episode sim with the HabitatSimLike surface."""

    # planar frame is right-handed z-up: turn_left = yaw+ = CCW in (x, y).
    # Read by the dialog oracle to orient left/right in path descriptions.
    planar_ccw = True

    def __init__(self, rgb_hw=(224, 224), max_steps: int = 500):
        self.rgb_hw = rgb_hw
        self.max_steps = max_steps
        self._ep: Optional[Episode] = None

    def reset(self, episode: Episode) -> Dict[str, Any]:
        self._ep = episode
        self.pose = np.asarray([episode.start_position[0],
                                episode.start_position[1], 0.0], np.float64)
        self.steps = 0
        self._over = False
        return self._obs()

    @property
    def position(self) -> np.ndarray:
        return np.asarray([self.pose[0], self.pose[1], 0.0])

    @property
    def yaw(self) -> float:
        return float(self.pose[2])

    @property
    def episode_over(self) -> bool:
        return self._over

    def step(self, action: int) -> Dict[str, Any]:
        a = int(action)
        if a == 1:
            self.pose[0] += FORWARD_DIST * np.cos(self.pose[2])
            self.pose[1] += FORWARD_DIST * np.sin(self.pose[2])
        elif a == 2:
            self.pose[2] += TURN_RAD
        elif a == 3:
            self.pose[2] -= TURN_RAD
        # look up/down (5/6) do not move the base
        self.steps += 1
        if a == 0 or self.steps >= self.max_steps:
            self._over = True
        return self._obs()

    def _obs(self) -> Dict[str, Any]:
        seed = abs(hash(self._ep.path_key)) % (2**31)
        rgb, depth = procedural_frame(self.pose, seed, *self.rgb_hw)
        return {"rgb": rgb, "depth": depth}


class NavmeshFakeSim(FakeSim):
    """FakeSim implementing the optional navmesh-follower protocol
    (`snap_point` + `follow_toward`) the evaluator prefers when a sim
    provides it — the reference's `pathfinder.snap_point` +
    `ShortestPathFollower` semantics (habitat_vln_evaluator.py:663,
    804-830). The walkable set is a corridor around the episode's
    reference path: goals snap to the nearest point on that polyline, and
    the follower greedily tracks the snapped goal."""

    def __init__(self, rgb_hw=(224, 224), max_steps: int = 500,
                 goal_radius: float = 0.25):
        super().__init__(rgb_hw, max_steps)
        self.goal_radius = goal_radius
        self.snap_calls = 0
        self.follow_calls = 0

    def snap_point(self, gps) -> np.ndarray:
        """Nearest point on the reference-path polyline (the navmesh)."""
        self.snap_calls += 1
        p = np.asarray(gps, np.float64)[:2]
        path = np.asarray(self._ep.reference_path, np.float64)[:, :2]
        if len(path) == 1:
            return path[0]
        best, best_d = path[0], np.inf
        for a, b in zip(path[:-1], path[1:]):
            ab = b - a
            t = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-9), 0, 1)
            q = a + t * ab
            d = np.linalg.norm(p - q)
            if d < best_d:
                best, best_d = q, d
        return best

    def follow_toward(self, goal_xy) -> int:
        self.follow_calls += 1
        goal = self.snap_point(goal_xy)
        pos = self.position[:2]
        d = goal - pos
        if np.linalg.norm(d) < self.goal_radius:
            return 0
        heading = (np.arctan2(d[1], d[0]) - self.yaw + np.pi) % (2 * np.pi) - np.pi
        if heading > TURN_RAD / 2:
            return 2
        if heading < -TURN_RAD / 2:
            return 3
        return 1


class HabitatSimAdapter:
    """Wraps habitat.Env (only importable when habitat is installed)."""

    # planar coords are (x_hab, z_hab): habitat yaw+ (a LEFT turn, about
    # +y) is clockwise in that plane, so the planar frame is left-handed.
    # The dialog oracle's (x, h, y) permutation therefore lands these
    # points in the habitat frame with correct chirality (no flip).
    planar_ccw = False

    LOOK_ACTIONS = {5: "look_down", 6: "look_up"}
    BASE_ACTIONS = {0: "stop", 1: "move_forward", 2: "turn_left", 3: "turn_right"}

    def __init__(self, cfg):
        import habitat

        config_path = cfg.env.env_settings.get("habitat_config")
        self._env = habitat.Env(config=habitat.get_config(config_path))
        self._obs = None

    def reset(self, episode: Episode) -> Dict[str, Any]:
        # manual current_episode advance (reference habitat_env.py:87-92)
        for i, ep in enumerate(self._env.episodes):
            if str(ep.episode_id) == episode.episode_id:
                self._env.current_episode = ep
                break
        self._obs = self._env.reset()
        return dict(self._obs)

    @property
    def position(self) -> np.ndarray:
        state = self._env.sim.get_agent_state()
        p = state.position
        return np.asarray([p[0], p[2], p[1]])  # habitat y-up → (x, y, z)

    @property
    def yaw(self) -> float:
        import quaternion  # habitat dep

        state = self._env.sim.get_agent_state()
        q = state.rotation
        return float(2 * np.arctan2(q.y, q.w))

    @property
    def heading(self) -> float:
        """Planar heading: habitat forward (-sin θ, -cos θ) in repo (x, y)
        coordinates → atan2 angle. Used by the dialog oracle."""
        theta = self.yaw
        return float(np.arctan2(-np.cos(theta), -np.sin(theta)))

    @property
    def episode_over(self) -> bool:
        return bool(self._env.episode_over)

    def find_path(self, start, end):
        """Navmesh shortest path between planar points (reference
        dialog_utils.py:21-27 get_shortest_path). Returns (planar points,
        success)."""
        import habitat_sim

        h = self.position[2]
        sp = habitat_sim.ShortestPath()
        sp.requested_start = [float(start[0]), h, float(start[1])]
        sp.requested_end = [float(end[0]), h, float(end[1])]
        ok = self._env.sim.pathfinder.find_path(sp)
        pts = [np.asarray([p[0], p[2], p[1]]) for p in sp.points]
        return pts, bool(ok)

    def step(self, action: int) -> Dict[str, Any]:
        name = self.LOOK_ACTIONS.get(int(action)) or self.BASE_ACTIONS.get(int(action), "stop")
        self._obs = self._env.step(name)
        return dict(self._obs)

    def snap_point(self, gps) -> np.ndarray:
        """Navmesh snap (reference habitat_vln_evaluator.py:663)."""
        goal = np.asarray([gps[0], self.position[2], gps[1]])
        snapped = np.asarray(self._env.sim.pathfinder.snap_point(goal))
        return np.asarray([snapped[0], snapped[2]])

    def follow_toward(self, goal_xy) -> int:
        from habitat.tasks.nav.shortest_path_follower import ShortestPathFollower

        if not hasattr(self, "_follower"):
            self._follower = ShortestPathFollower(self._env.sim, 0.25, False)
        goal = np.asarray([goal_xy[0], self.position[2], goal_xy[1]])
        snapped = self._env.sim.pathfinder.snap_point(goal)
        act = self._follower.get_next_action(snapped)
        return {None: 0, "stop": 0, "move_forward": 1, "turn_left": 2,
                "turn_right": 3}.get(act, int(act) if act is not None else 0)

    def get_metrics(self) -> Dict[str, Any]:
        return self._env.get_metrics()
