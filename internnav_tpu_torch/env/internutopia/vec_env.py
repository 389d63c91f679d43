"""FakePhysicsVecEnv — a kinematic stand-in for InternUtopia's vectorized
Isaac environment, implementing the substep/finish_action protocol.

Interface parity with `internutopia.core.vec_env.Env` as the reference
consumes it (internnav/env/internutopia_env.py:61-80 and
vln_distributed_evaluator.py:env_step):
- `reset(reset_index)` -> (obs_list, info_list)
- `step(actions)` with per-env `{robot_name: {controller: args}}` dicts ->
  (obs, reward, terminated, truncated, info); ONE call = ONE physics tick
- obs dicts keyed by robot name.

Task semantics parity with VLNEvalTask.get_observations
(internutopia_extension/tasks/vln_eval_task.py:131-216):
- macro-step atomicity: `finish_action` is False (and RGB-D absent) until a
  discrete action's steps_per_action physics ticks have elapsed;
- warm-up: `stand_still` decrements warm_up_step per tick until 1, then
  finishes with an RGB-D capture (and re-arms warm_up for physical mode);
- flash and speed commands finish in one tick;
- `stop` finishes with no RGB-D, the done checker decides
  success/not_reach_goal;
- poses are reported without env offsets; metrics + fail_reason are
  attached on done.

The loco policy path (H1SpeedController, the h1_loco_jit_policy port) can
be enabled with use_loco=True to exercise the 492-dim observation + the
loco actor per tick; pose integration stays kinematic either way.

Copy of internnav_tpu/env/internutopia/vec_env.py,
kept in the port so that it imports nothing of the JAX package, except
that with use_loco each env's controller runs its actor on `device`: the
GPU by default (no CUDA device: raises), the CPU when asked for.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from internnav_tpu_torch.env.checkers import DoneChecker
from internnav_tpu_torch.env.fake_env import procedural_frame
from internnav_tpu_torch.env.internutopia.loco import H1RobotState, H1SpeedController
from internnav_tpu_torch.env.metrics import VLNPEMetrics
from internnav_tpu_torch.env.task_gen import VLNEvalTaskSpec

STOP, FORWARD, LEFT, RIGHT = 0, 1, 2, 3

KNOWN_CONTROLLERS = (
    "stand_still", "move_by_discrete", "vln_move_by_speed",
    "vln_dp_move_by_speed", "move_by_flash", "stop",
)


def yaw_to_quat(yaw: float) -> np.ndarray:
    from internnav_tpu_torch.utils.geometry import quat_wxyz_from_yaw

    return quat_wxyz_from_yaw(yaw)


@dataclass
class _TaskSlot:
    """One env's episode + physics + FSM state."""

    spec: Optional[VLNEvalTaskSpec] = None
    pose: np.ndarray = field(default_factory=lambda: np.zeros(3))  # x, y, yaw
    z: float = 1.05  # standing base height
    warm_up_step: int = 0
    step_count: int = 0
    substeps_left: int = 0
    speed_cmd: Tuple[float, float] = (0.0, 0.0)
    current_action: Optional[Dict[str, Any]] = None
    done: bool = False
    metrics: Optional[VLNPEMetrics] = None
    checker: Optional[DoneChecker] = None
    fail_reason: str = ""
    finished_episode: bool = True  # no episode loaded yet


class FakePhysicsVecEnv:
    """Vectorized kinematic physics with VLNEvalTask observation semantics."""

    def __init__(self, task_specs: Sequence[VLNEvalTaskSpec], env_num: int = 1,
                 robot_name: str = "h1", steps_per_action: int = 50,
                 physics_frequency: int = 200, rgb_hw: Tuple[int, int] = (256, 256),
                 use_loco: bool = False, forward_distance: float = 0.25,
                 rotation_angle_deg: float = 15.0, one_step_stand_still: bool = False,
                 device=None):
        self.specs = list(task_specs)
        self._next = 0
        self.env_num = env_num
        self.robot_name = robot_name
        self.steps_per_action = steps_per_action
        self.physics_frequency = physics_frequency
        self.rgb_hw = tuple(rgb_hw)
        self.one_step_stand_still = one_step_stand_still
        self.forward_speed = forward_distance / steps_per_action * physics_frequency
        self.rotation_speed = np.deg2rad(
            rotation_angle_deg / steps_per_action * physics_frequency)
        self.slots = [_TaskSlot() for _ in range(env_num)]
        self.loco = [H1SpeedController(device=device) for _ in range(env_num)] \
            if use_loco else None
        self.loco_calls = 0

    # ------------------------------------------------------------- episodes
    def _assign(self, slot: _TaskSlot) -> bool:
        if self._next >= len(self.specs):
            slot.spec = None
            slot.done = True
            slot.finished_episode = True
            return False
        spec = self.specs[self._next]
        self._next += 1
        ep = spec.episode
        slot.spec = spec
        start = np.asarray(spec.start_position, np.float64).ravel()
        yaw = _quat_or_yaw(spec.start_rotation)
        slot.pose = np.array([start[0], start[1], yaw])
        slot.warm_up_step = spec.warm_up_step
        slot.step_count = 0
        slot.substeps_left = 0
        slot.current_action = None
        slot.done = False
        slot.finished_episode = False
        slot.fail_reason = ""
        slot.metrics = VLNPEMetrics(
            reference_path=np.asarray(ep.reference_path),
            geodesic_distance=ep.geodesic_distance,
            success_distance=spec.metric.success_distance,
            episode_id=ep.episode_id,
            trajectory_id=ep.trajectory_id,
            path_key=ep.path_key,
        )
        slot.metrics.start(slot.pose[:2])
        slot.checker = DoneChecker(max_step=spec.max_step)
        slot.checker.reset(slot.pose[:2], slot.pose[2])
        return True

    # ------------------------------------------------------------------ api
    def reset(self, reset_index: Optional[List[int]] = None):
        ids = list(range(self.env_num)) if reset_index is None else list(reset_index)
        for i in ids:
            self._assign(self.slots[i])
            if self.loco:
                self.loco[i].reset()
        obs = [self._observe(s, first=True) for s in self.slots]
        infos = [_Info(s.spec) for s in self.slots]
        return obs, infos

    def step(self, actions: Sequence[Dict[str, Dict[str, Any]]]):
        """One physics tick for each env."""
        assert len(actions) == self.env_num, (len(actions), self.env_num)
        obs, terminated = [], []
        for i, (slot, act) in enumerate(zip(self.slots, actions)):
            if slot.spec is None or slot.done:
                obs.append(self._observe(slot))
                terminated.append(slot.done)
                continue
            inner = act.get(self.robot_name, {}) if isinstance(act, dict) else {}
            name = next(iter(inner), None)
            if name is not None and name not in KNOWN_CONTROLLERS:
                raise ValueError(f"Got invalid action name {name}!!!")
            self._apply(i, slot, name, inner.get(name))
            obs.append(self._observe(slot))
            terminated.append(slot.done)
        rewards = [0.0] * self.env_num
        truncated = [False] * self.env_num
        infos = [_Info(s.spec) for s in self.slots]
        return obs, rewards, terminated, truncated, infos

    def get_observations(self):
        return [self._observe(s) for s in self.slots]

    def render_frames(self):
        """Side-effect-free rgb/depth capture of every live slot at its
        current pose (no step accounting, no physics). Used by the batch
        adapter to give freshly reset slots a real first frame — something
        real Isaac cannot do pre-settle, but the kinematic backend can."""
        return [self._render(s) if (s.spec is not None and not s.done)
                else None for s in self.slots]

    def close(self) -> None:
        pass

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self.specs)

    # -------------------------------------------------------------- physics
    def _apply(self, idx: int, slot: _TaskSlot, name: Optional[str], args) -> None:
        """Apply one tick of the named controller (reference robot
        apply_action + controller forward semantics)."""
        if name is None:
            slot.current_action = None
            return
        slot.current_action = {name: args}
        v = w = 0.0
        if name == "move_by_discrete":
            a = int(np.asarray(args).ravel()[0])
            if slot.substeps_left <= 0:  # new macro action
                slot.substeps_left = self.steps_per_action
            if a == FORWARD:
                v = self.forward_speed
            elif a == LEFT:
                w = self.rotation_speed
            elif a == RIGHT:
                w = -self.rotation_speed
            slot.substeps_left -= 1
        elif name == "move_by_flash":
            a = int(np.asarray(args).ravel()[0])
            x, y, yaw = slot.pose
            if a == FORWARD:
                x += 0.25 * np.cos(yaw)
                y += 0.25 * np.sin(yaw)
            elif a == LEFT:
                yaw += np.deg2rad(15.0)
            elif a == RIGHT:
                yaw -= np.deg2rad(15.0)
            slot.pose = np.array([x, y, yaw])
            return
        elif name in ("vln_move_by_speed", "vln_dp_move_by_speed"):
            arr = np.asarray(args, np.float64).ravel()
            v = float(arr[0]) if arr.size else 0.0
            w = float(arr[2]) if arr.size >= 3 else 0.0
        # stand_still / stop: v = w = 0
        if self.loco is not None and name in (
                "vln_move_by_speed", "vln_dp_move_by_speed", "move_by_discrete"):
            state = self._robot_state(slot)
            self.loco[idx].action_to_control(state, [v, 0.0, w])
            self.loco_calls += 1
        dt = 1.0 / self.physics_frequency
        x, y, yaw = slot.pose
        slot.pose = np.array([x + v * np.cos(yaw) * dt,
                              y + v * np.sin(yaw) * dt,
                              yaw + w * dt])

    def _robot_state(self, slot: _TaskSlot) -> H1RobotState:
        quat = yaw_to_quat(slot.pose[2])
        pos = np.array([slot.pose[0], slot.pose[1], slot.z])
        return H1RobotState(
            base_position=pos,
            torso_position=pos + np.array([0.0, 0.0, 0.2]),
            torso_quat=quat, imu_quat=quat,
            imu_ang_vel=np.zeros(3),
            joint_positions=np.zeros(19, np.float32),
            joint_velocities=np.zeros(19, np.float32),
            ankle_height=0.1,
            pointcloud=None,
        )

    # ---------------------------------------------------------- observation
    def _render(self, slot: _TaskSlot) -> Dict[str, np.ndarray]:
        seed = abs(hash(slot.spec.path_key)) % (2**31)
        rgb, depth = procedural_frame(slot.pose, seed, *self.rgb_hw)
        return {"rgb": rgb, "depth": depth}

    def _observe(self, slot: _TaskSlot, first: bool = False) -> Optional[Dict[str, Any]]:
        """VLNEvalTask.get_observations parity (vln_eval_task.py:131-216)."""
        if slot.spec is None:
            return None
        obs: Dict[str, Any] = {"finish_action": False}
        obs["globalgps"] = np.array([slot.pose[0], slot.pose[1], slot.z])
        obs["globalrotation"] = yaw_to_quat(slot.pose[2])
        if slot.done:
            obs["finish_action"] = True
            obs["metrics"] = slot.metrics.calc()
            obs["fail_reason"] = slot.fail_reason
            return {self.robot_name: obs}

        action = slot.current_action
        if action is None or first:
            return {self.robot_name: obs}
        name = next(iter(action))

        slot.step_count += 1
        if name == "stand_still":
            if slot.warm_up_step > 1:
                slot.step_count -= 1
                slot.warm_up_step -= 1
                slot.current_action = None
                return {self.robot_name: obs}
            obs.update(self._render(slot))
            if (not slot.spec.robot_flash) and not self.one_step_stand_still:
                slot.warm_up_step = 50
        elif name == "move_by_discrete":
            if slot.substeps_left > 0:
                slot.current_action = None
                return {self.robot_name: obs}
            obs.update(self._render(slot))
        elif name in ("vln_move_by_speed", "vln_dp_move_by_speed"):
            obs.update(self._render(slot))
        elif name == "move_by_flash":
            obs.update(self._render(slot))
        # 'stop' falls through with no RGB capture

        obs["finish_action"] = True
        slot.current_action = None
        a_for_checker = STOP if name == "stop" else -1
        done, reason = slot.checker.update(
            a_for_checker, np.array([slot.pose[0], slot.pose[1], slot.z]),
            slot.pose[2], yaw_to_quat(slot.pose[2]),
        )
        slot.metrics.update(slot.pose[:2], finish_action=True,
                            fail_reason="" if reason in ("", "stop") else reason)
        if done:
            slot.done = True
            m = slot.metrics.calc()
            if name == "stop":
                reason = "success" if m.get("success") else "not_reach_goal"
            slot.fail_reason = reason
            m["fail_reason"] = reason
            slot.metrics.fail_reason = reason
            obs["metrics"] = m
        obs["fail_reason"] = slot.fail_reason
        ep = slot.spec.episode
        obs["instruction"] = ep.instruction_text
        obs["instruction_tokens"] = ep.instruction_tokens
        return {self.robot_name: obs}


class _Info:
    """Reset-info shim matching the reference's `info.data['path_key']`."""

    def __init__(self, spec: Optional[VLNEvalTaskSpec]):
        self.data = {
            "path_key": spec.path_key if spec else None,
            "instruction": {
                "instruction_text": spec.episode.instruction_text,
                "instruction_tokens": spec.episode.instruction_tokens,
            } if spec else None,
        }


def _quat_or_yaw(rot) -> float:
    from internnav_tpu_torch.utils.geometry import yaw_from_quat_wxyz

    rot = np.asarray(rot, np.float64).ravel()
    if rot.size == 4:
        return yaw_from_quat_wxyz(rot)
    return float(rot[0]) if rot.size else 0.0
