"""Offline / kinematic environment — the framework's simulator-free backend.

Two roles (SURVEY.md §4 calls this out as the fixture the reference lacks):
1. Test fixture: deterministic procedural RGB-D observations from the agent
   pose, so policies and evaluators run end-to-end with no simulator.
2. Kinematic VLN-PE "flash controller" semantics: discrete actions teleport
   the agent (0 stop / 1 forward 0.25 m / 2 left 15° / 3 right 15°), which
   is exactly the reference's VlnMoveByFlashController behavior
   (h1_vln_move_by_flash_controller.py:13-135, discrete_controller.py:12-94).
3. Replay mode: if an episode's extra['obs_frames'] contains recorded
   rgb/depth arrays, those are served instead of procedural frames
   (offline-replay evaluation of recorded trajectories).

Copy of internnav_tpu/env/fake_env.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from internnav_tpu_torch.configs.evaluator import EnvCfg, TaskCfg
from internnav_tpu_torch.env.base import Env
from internnav_tpu_torch.env.episodes import Episode
from internnav_tpu_torch.env.metrics import VLNPEMetrics

STOP, FORWARD, LEFT, RIGHT = 0, 1, 2, 3
FORWARD_DIST = 0.25
TURN_RAD = np.radians(15.0)


@dataclass
class _Slot:
    episode: Optional[Episode] = None
    pose: np.ndarray = field(default_factory=lambda: np.zeros(3))  # x, y, yaw
    steps: int = 0
    done: bool = True
    terminated: bool = False  # no more episodes for this slot
    metrics: Optional[VLNPEMetrics] = None
    stop_called: bool = False


def procedural_frame(pose: np.ndarray, episode_seed: int, h: int, w: int):
    """Deterministic RGB-D derived from (pose, episode): smooth gradients
    keyed by position/heading so a recurrent policy sees a consistent,
    pose-dependent world."""
    x, y, yaw = float(pose[0]), float(pose[1]), float(pose[2])
    rs = np.random.RandomState(episode_seed % (2**31))
    base = rs.randint(0, 64, size=(3,))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = xx / w * 2 * np.pi + yaw
    pv = yy / h * 2 * np.pi
    r = (np.sin(ph + x) * 0.5 + 0.5) * 128 + base[0]
    g = (np.cos(pv + y) * 0.5 + 0.5) * 128 + base[1]
    b = (np.sin(ph + pv + x - y) * 0.5 + 0.5) * 128 + base[2]
    rgb = np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
    depth = ((np.sin(ph * 2 + x + y) * 0.5 + 0.5)).astype(np.float32)[..., None]
    return rgb, depth


@Env.register("fake")
class FakeEnv(Env):
    """Vectorized kinematic env over a list of episodes."""

    def __init__(self, env_cfg: EnvCfg, task_cfg: Optional[TaskCfg] = None,
                 episodes: Optional[Sequence[Episode]] = None):
        super().__init__(env_cfg, task_cfg)
        s = env_cfg.env_settings
        self.episodes: List[Episode] = list(episodes if episodes is not None else s.get("episodes", []))
        self.rgb_hw = tuple(s.get("rgb_resolution", self.task_cfg.camera_resolution or [256, 256]))
        self.depth_hw = tuple(s.get("depth_resolution", [256, 256]))
        self.max_step = self.task_cfg.max_step
        self.success_distance = self.task_cfg.metric_config.success_distance
        self.instr_pad_len = int(s.get("instruction_pad_len", 200))
        # controller selection: flash (teleport) vs discrete (physical-mode
        # speed integration) — the reference's two benchmark modes
        from internnav_tpu_torch.env.controllers import build_controller

        kind = s.get("controller", "flash" if self.task_cfg.robot_flash else "flash")
        self.controller = build_controller(kind)
        self._next_idx = 0
        self.slots = [_Slot() for _ in range(self.env_num)]
        self.results: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- episodes
    def _pop_episode(self) -> Optional[Episode]:
        if self._next_idx >= len(self.episodes):
            return None
        ep = self.episodes[self._next_idx]
        self._next_idx += 1
        return ep

    @staticmethod
    def _start_yaw(ep: Episode) -> float:
        rot = np.asarray(ep.start_rotation, dtype=np.float64).ravel()
        if rot.size == 1:
            return float(rot[0])
        if rot.size == 4:  # quaternion (w, x, y, z) → yaw
            w, x, y, z = rot
            return float(np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)))
        return 0.0

    # ------------------------------------------------------------------ api
    def reset(self, env_ids: Optional[List[int]] = None) -> List[Optional[Dict[str, Any]]]:
        ids = list(range(self.env_num)) if env_ids is None else env_ids
        for i in ids:
            ep = self._pop_episode()
            slot = self.slots[i]
            if ep is None:
                slot.episode = None
                slot.terminated = True
                slot.done = True
                continue
            slot.episode = ep
            slot.pose = np.array(
                [ep.start_position[0], ep.start_position[1], self._start_yaw(ep)]
            )
            slot.steps = 0
            slot.done = False
            slot.stop_called = False
            slot.metrics = VLNPEMetrics(
                reference_path=np.asarray(ep.reference_path),
                geodesic_distance=ep.geodesic_distance,
                success_distance=self.success_distance,
                episode_id=ep.episode_id,
                trajectory_id=ep.trajectory_id,
                path_key=ep.path_key,
            )
            slot.metrics.start(slot.pose[:2])
        if all(s.terminated for s in self.slots):
            self._is_running = False
        return self.get_observation()

    def step(self, actions: Sequence[Any]) -> List[Dict[str, Any]]:
        assert len(actions) == self.env_num, (len(actions), self.env_num)
        for i, (slot, action) in enumerate(zip(self.slots, actions)):
            if slot.terminated or slot.done or slot.episode is None:
                continue
            a = int(action)
            fail = ""
            if a == STOP:
                slot.stop_called = True
            else:
                slot.pose, _ = self.controller.apply(slot.pose, a)
            slot.steps += 1
            if a == STOP:
                slot.done = True
            elif slot.steps >= self.max_step:
                slot.done = True
                fail = "exceed_max_step"
            slot.metrics.update(slot.pose[:2], finish_action=True, fail_reason=fail)
            if slot.done:
                self.results.append(slot.metrics.calc())
        return self.get_observation()

    def get_observation(self) -> List[Optional[Dict[str, Any]]]:
        out: List[Optional[Dict[str, Any]]] = []
        for slot in self.slots:
            if slot.terminated or slot.episode is None:
                out.append(None)
                continue
            ep = slot.episode
            frames = ep.extra.get("obs_frames")
            t = min(slot.steps, len(frames["rgb"]) - 1) if frames else 0
            if frames:
                rgb = np.asarray(frames["rgb"][t])
                depth = np.asarray(frames["depth"][t])
            else:
                seed = abs(hash(ep.path_key)) % (2**31)
                rgb, depth = procedural_frame(slot.pose, seed, *self.rgb_hw)
            tokens = ep.instruction_tokens
            if tokens is None:
                tokens = np.zeros((0,), np.int32)
            padded = np.zeros((self.instr_pad_len,), np.int32)
            padded[: min(len(tokens), self.instr_pad_len)] = tokens[: self.instr_pad_len]
            out.append(
                {
                    "rgb": rgb,
                    "depth": depth,
                    "instruction": padded,
                    "instruction_text": ep.instruction_text,
                    "globalgps": np.array([slot.pose[0], slot.pose[1], 0.0]),
                    "yaw": float(slot.pose[2]),
                    "episode_id": ep.episode_id,
                    "path_key": ep.path_key,
                    "done": slot.done,
                    "finish_action": True,
                    "steps": slot.steps,
                }
            )
        return out

    # ------------------------------------------------------- bookkeeping
    @property
    def episode_results(self) -> List[Dict[str, Any]]:
        return self.results

    def active_mask(self) -> np.ndarray:
        return np.array([not (s.done or s.terminated) for s in self.slots])
