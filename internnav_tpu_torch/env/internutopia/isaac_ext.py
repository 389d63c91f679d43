"""Isaac Sim / InternUtopia extension registrations.

Reference parity: internnav/env/utils/internutopia_extension/ — the
`VLNEvalTask` (tasks/vln_eval_task.py:9-216), `VLNCamera`
(sensors/vln_camera.py), `VLNH1Robot` (robots/h1.py), and the controller
set. Everything here only runs when InternUtopia/Isaac is importable;
`register()` raises otherwise. The module itself imports cleanly anywhere
(the adapter-contract tests exercise it with no simulator), because the
class definitions live inside `register()`.

The task/controller *semantics* live in backend-neutral code —
FakePhysicsVecEnv (vec_env.py) for the substep/finish_action FSM and
H1SpeedController (loco.py) for the loco policy — so the Isaac classes
below are thin bindings from InternUtopia's registries onto those
implementations plus the Isaac-only pieces (lights, replicator capture,
articulation actions).

Copy of internnav_tpu/env/internutopia/isaac_ext.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_REGISTERED = False


def task_cfg_from_spec(spec) -> Dict[str, Any]:
    """VLNEvalTaskSpec -> the dict InternUtopia's Config consumes as one
    task config (reference generate_episode.py:38-107 output shape)."""
    ep = spec.episode
    return {
        "type": "VLNEvalTask",
        "scene_asset_path": spec.scene_asset,
        "warm_up_step": spec.warm_up_step,
        "max_step": spec.max_step,
        "robot_flash": spec.robot_flash,
        "one_step_stand_still": False,
        "data": {
            "path_key": spec.path_key,
            "start_position": list(map(float, np.asarray(spec.start_position).ravel())),
            "start_rotation": list(map(float, np.asarray(spec.start_rotation).ravel())),
            "reference_path": np.asarray(ep.reference_path).tolist(),
            "geodesic_distance": ep.geodesic_distance,
            "instruction": {
                "instruction_text": ep.instruction_text,
                "instruction_tokens": (np.asarray(ep.instruction_tokens).tolist()
                                       if ep.instruction_tokens is not None else []),
            },
        },
        "metric": {"success_distance": spec.metric.success_distance},
    }


def register() -> None:
    """Register VLNEvalTask / VLNCamera / VLNH1Robot / controllers with
    InternUtopia. Raises RuntimeError when the stack is missing."""
    global _REGISTERED
    if _REGISTERED:
        return
    try:
        from internutopia.core.robot.controller import BaseController
        from internutopia.core.robot.robot import BaseRobot
        from internutopia.core.sensor.sensor import BaseSensor
        from internutopia.core.task import BaseTask
        from internutopia_extension.robots.h1 import H1Robot
    except ImportError as e:
        raise RuntimeError(
            "InternUtopia modules could not be imported. "
            "Make sure both repositories are installed and on PYTHONPATH."
        ) from e

    from internnav_tpu_torch.env.checkers import DoneChecker
    from internnav_tpu_torch.env.internutopia.loco import H1RobotState, H1SpeedController
    from internnav_tpu_torch.env.metrics import VLNPEMetrics

    @BaseTask.register("VLNEvalTask")
    class VLNEvalTask(BaseTask):  # noqa: F811 (registry-owned)
        """Macro-step-atomic VLN task (reference vln_eval_task.py:9-216)."""

        def __init__(self, config, scene):
            super().__init__(config, scene)
            self.step_count = 0
            self.data = config.data
            self.warm_up_step = config.warm_up_step
            self.config = config
            self._done = None
            self._fail_reason = ""

        def load(self):
            super().load()
            self.robot_name = list(self.robots.keys())[0]
            self.robot = self.robots[self.robot_name]
            self.done_checker = DoneChecker(max_step=self.config.max_step)
            self.metrics_acc = VLNPEMetrics(
                reference_path=np.asarray(self.data["reference_path"]),
                geodesic_distance=self.data["geodesic_distance"],
                success_distance=self.config.metric["success_distance"],
                path_key=self.data["path_key"],
            )

        def post_reset(self):
            for robot in self.robots.values():
                robot.post_reset()
            self.robot = self.robots[self.robot_name]
            pos, _ = self._poses()
            self.metrics_acc.start(pos[:2])
            self.done_checker.reset(pos)

        def is_done(self) -> bool:
            return bool(self._done) if self._done is not None else False

        def _poses(self):
            pre_position, pre_rotation = self.robot.articulation.get_world_pose()
            return pre_position - self.env_offset, pre_rotation

        def get_rgb_depth(self):
            obs = {}
            if "pano_camera_0" in self.robot.sensors:
                cur = self.robot.sensors["pano_camera_0"].get_data()
                obs["rgb"] = cur["rgba"][..., :3]
                depth = np.asarray(cur["depth"], np.float32)
                obs["depth"] = depth[..., None]
            return obs

        def get_observations(self):
            obs: Dict[str, Any] = {"finish_action": False}
            obs["globalgps"], obs["globalrotation"] = self._poses()
            if self._done:
                obs["finish_action"] = True
                obs["metrics"] = self.metrics_acc.calc()
                return {self.robot_name: obs}
            action = self.robot.current_action
            if action is None:
                return {self.robot_name: obs}
            name = list(action.keys())[0]
            self.step_count += 1
            if name == "stand_still":
                if self.warm_up_step > 1:
                    self.step_count -= 1
                    self.warm_up_step -= 1
                    self.robot.current_action = None
                    return {self.robot_name: obs}
                obs.update(self.get_rgb_depth())
                if not self.config.robot_flash and not self.config.one_step_stand_still:
                    self.warm_up_step = 50
            elif name in ("move_by_discrete", "vln_move_by_speed",
                          "vln_dp_move_by_speed"):
                ctrl = self.robot.controllers[name]
                if not ctrl.get_obs()["finished"]:
                    if name == "move_by_discrete":
                        self.robot.current_action = None
                    return {self.robot_name: obs}
                obs.update(self.get_rgb_depth())
            elif name == "move_by_flash":
                obs.update(self.get_rgb_depth())
            elif name != "stop":
                raise ValueError(f"Got invalid action name {name}!!!")

            obs["finish_action"] = True
            self.robot.current_action = None
            pos, quat = self._poses()
            done, reason = self.done_checker.update(
                0 if name == "stop" else -1, pos, 0.0, quat)
            self.metrics_acc.update(pos[:2], finish_action=True,
                                    fail_reason="" if not reason else reason)
            self._done = done
            if done:
                m = self.metrics_acc.calc()
                if name == "stop":
                    reason = "success" if m.get("success") else "not_reach_goal"
                m["fail_reason"] = reason
                self._fail_reason = reason
                obs["metrics"] = m
            obs["fail_reason"] = self._fail_reason
            obs["instruction"] = self.data["instruction"]["instruction_text"]
            obs["instruction_tokens"] = self.data["instruction"]["instruction_tokens"]
            return {self.robot_name: obs}

    @BaseSensor.register("VLNCamera")
    class VLNCamera(BaseSensor):  # noqa: F811
        """Replicator camera wrapper producing rgba+depth
        (reference sensors/vln_camera.py)."""

        def __init__(self, config, robot, scene):
            super().__init__(config, robot, scene)
            self.config = config
            self._camera = None
            # consumed by the collision controller's occupancy checker
            # (reference vln_camera.py:24 defines it the same way)
            self.resolution = config.resolution

        def get_data(self) -> Dict:
            data = {"rgba": self._camera.get_rgba(),
                    "depth": self._camera.get_distance_to_image_plane()}
            return self._make_ordered(data)

        def get_world_pose(self):
            """(position, orientation) of the camera prim (reference
            vln_camera.py:66-67) — the occupancy map recentering needs
            the top-down camera's world x/y."""
            return self._camera.get_world_pose()

        def set_world_pose(self, *args, **kwargs):
            self._camera.set_world_pose(*args, **kwargs)

        def post_reset(self):
            from internutopia.core.sensor.camera import ICamera

            if self._camera is not None:
                self._camera.cleanup()
            prim_path = self._robot.config.prim_path + "/" + self.config.prim_path
            self._camera = ICamera.create(
                name=self.config.name, prim_path=prim_path, rgba=True,
                distance_to_image_plane=True, resolution=self.config.resolution,
            )

    @BaseRobot.register("VLNH1Robot")
    class VLNH1Robot(H1Robot):  # noqa: F811
        """H1 wrapper tracking current_action for macro-step atomicity
        (reference robots/h1.py)."""

        def __init__(self, config, scene):
            super().__init__(config, scene)
            self.current_action = None

        def post_reset(self):
            super().post_reset()
            self._torso_link = self._rigid_body_map[self.config.prim_path + "/torso_link"]
            self._imu_link = self._rigid_body_map[self.config.prim_path + "/imu_link"]

        def apply_action(self, action: dict):
            self.current_action = action
            return super().apply_action(action)

        def robot_state(self) -> H1RobotState:
            base_pos, _ = self.articulation.get_world_pose()
            torso_pos, torso_quat = self._torso_link.get_world_pose()
            imu_pos, imu_quat = self._imu_link.get_world_pose()
            pc = None
            if "tp_pointcloud" in self.sensors:
                pc = self.sensors["tp_pointcloud"].get_data().get("pointcloud")
            return H1RobotState(
                base_position=np.asarray(base_pos),
                torso_position=np.asarray(torso_pos),
                torso_quat=np.asarray(torso_quat),
                imu_quat=np.asarray(imu_quat),
                imu_ang_vel=np.asarray(self._imu_link.get_angular_velocity()),
                joint_positions=np.asarray(self.articulation.get_joint_positions()),
                joint_velocities=np.asarray(self.articulation.get_joint_velocities()),
                ankle_height=float(self.get_ankle_height()),
                pointcloud=pc,
            )

    @BaseController.register("VlnMoveBySpeedController")
    class VlnMoveBySpeedController(BaseController):  # noqa: F811
        """Loco speed controller binding: obs-building + the actor live in
        H1SpeedController (loco.py), on the config's `device` (the GPU by
        default)."""

        def __init__(self, config, robot, scene):
            super().__init__(config=config, robot=robot, scene=scene)
            device = getattr(config, "device", None)
            path = getattr(config, "policy_weights_path", None)
            if path:
                from internnav_tpu_torch.env.internutopia.loco import convert_loco_policy

                self.impl = H1SpeedController(actor=convert_loco_policy(path, device=device))
            else:
                self.impl = H1SpeedController(device=device)

        def action_to_control(self, action):
            from internutopia.core.robot.articulation import ArticulationAction

            targets = self.impl.action_to_control(self.robot.robot_state(), action)
            return ArticulationAction(joint_positions=targets)

        def get_obs(self):
            return self.impl.get_obs()

    def _own_speed_impl(ctrl_self):
        """A PRIVATE H1SpeedController for a delegating controller
        (StandStill/Discrete), lazily built over the loco actor of the
        robot's registered speed controller. Private because
        H1SpeedController carries per-command state (_apply_times_left,
        cached joint targets): sharing one instance across controllers
        would replay a previous controller's cached targets at macro-step
        boundaries — the reference gives each controller its own
        sub_controllers[0] for the same reason. Raises when the robot has
        no speed controller at all (a silent no-op would run whole
        episodes with a frozen robot)."""
        impl = getattr(ctrl_self, "_impl", None)
        if impl is not None:
            return impl
        base = ctrl_self.robot.controllers.get("vln_move_by_speed") \
            or ctrl_self.robot.controllers.get("vln_dp_move_by_speed")
        if base is None:  # any registered speed controller binding
            base = next((c for c in ctrl_self.robot.controllers.values()
                         if hasattr(c, "impl")), None)
        base_impl = getattr(base, "impl", None)
        if base_impl is None:
            raise RuntimeError(
                f"{type(ctrl_self).__name__} needs a loco speed controller "
                "(VlnMoveBySpeedController) on the robot to delegate to — "
                "none is registered in robot.controllers")
        ctrl_self._impl = H1SpeedController(actor=base_impl.actor)
        return ctrl_self._impl

    @BaseController.register("StandStillController")
    class StandStillController(BaseController):  # noqa: F811
        """Zero-velocity locomotion (reference stand_still.py:12-46):
        the loco policy balances in place."""

        def action_to_control(self, action):
            from internutopia.core.robot.articulation import ArticulationAction

            targets = _own_speed_impl(self).forward(
                self.robot.robot_state(), forward_speed=0.0,
                rotation_speed=0.0, lateral_speed=0.0)
            return ArticulationAction(joint_positions=targets)

        def get_obs(self):
            return {"finished": True}

    @BaseController.register("DiscreteController")
    class DiscreteController(BaseController):  # noqa: F811
        """Habitat-style discrete action walked by the loco policy over
        steps_per_action physics substeps (reference
        discrete_controller.py:16-94): speeds derive from
        distance/angle x physics_frequency / steps_per_action."""

        def __init__(self, config, robot, scene):
            super().__init__(config=config, robot=robot, scene=scene)
            self.steps_per_action = getattr(config, "steps_per_action",
                                            None) or 200
            fd = getattr(config, "forward_distance", None) or 0.25
            ra = getattr(config, "rotation_angle", None) or 15.0
            pf = getattr(config, "physics_frequency", None) or 240
            self.forward_speed = fd / self.steps_per_action * pf
            self.rotation_speed = np.deg2rad(ra / self.steps_per_action * pf)
            self.current_action = None
            self.current_steps = 0

        def action_to_control(self, action):
            from internutopia.core.robot.articulation import ArticulationAction

            a = int(np.asarray(action).ravel()[0])
            if a not in (0, 1, 2, 3):
                # fail loudly at the source (reference
                # discrete_controller.py:68-69)
                raise ValueError(f"Invalid action: {a}")
            if self.current_action != a:
                self.current_action = a
                self.current_steps = 0
            self.current_steps += 1
            v = self.forward_speed if a == 1 else 0.0
            w = {2: self.rotation_speed, 3: -self.rotation_speed}.get(a, 0.0)
            targets = _own_speed_impl(self).forward(
                self.robot.robot_state(), forward_speed=v,
                rotation_speed=w, lateral_speed=0.0)
            return ArticulationAction(joint_positions=targets)

        def get_obs(self):
            finished = self.current_steps >= self.steps_per_action
            if finished:
                self.current_action = None
            return {"current_action": self.current_action,
                    "current_steps": self.current_steps,
                    "finished": finished}

    # roll/pitch zeroed on turns on purpose: accumulated tilt over a long
    # path would topple the teleported robot (reference
    # vln_move_by_flash_with_collision_controller.py:42-87)
    from internnav_tpu_torch.utils.geometry import (
        quat_wxyz_from_yaw as _quat_wxyz_from_yaw,
        yaw_from_quat_wxyz as _yaw_from_quat_wxyz,
    )

    @BaseController.register("VlnMoveByFlashController")
    class VlnMoveByFlashController(BaseController):  # noqa: F811
        """Teleport ('flash') locomotion: forward 0.25 m / turn 15° per
        discrete action, joint state zeroed after each teleport
        (reference controller :160-183; pose math :42-87)."""

        def __init__(self, config, robot, scene):
            super().__init__(config=config, robot=robot, scene=scene)
            self.forward_distance = getattr(config, "forward_distance", 0.25)
            self.rotation_angle = getattr(config, "rotation_angle", 15.0)

        def _new_pose(self, pos, quat, action):
            yaw = _yaw_from_quat_wxyz(quat)
            if action == 1:  # forward
                d = self.forward_distance
                return pos + np.array([d * np.cos(yaw), d * np.sin(yaw), 0.0]), quat
            if action == 2:  # left
                return pos, _quat_wxyz_from_yaw(yaw + np.deg2rad(self.rotation_angle))
            if action == 3:  # right
                return pos, _quat_wxyz_from_yaw(yaw - np.deg2rad(self.rotation_angle))
            return pos, quat

        def _allow(self, action, new_pos):
            return True

        def _teleport(self, pos, quat):
            art = self.robot.articulation
            inner = getattr(art, "_articulation", art)
            inner.set_world_pose(position=pos, orientation=quat)
            n = len(art.dof_names)
            if hasattr(inner, "set_world_velocity"):
                inner.set_world_velocity(np.zeros(6))
            inner.set_joint_velocities(np.zeros(n))
            inner.set_joint_positions(np.zeros(n))
            inner.set_joint_efforts(np.zeros(n))

        def action_to_control(self, action):
            from internutopia.core.robot.articulation import ArticulationAction

            a = int(np.asarray(action).ravel()[0])
            pos, quat = self.robot.articulation.get_world_pose()
            new_pos, new_quat = self._new_pose(np.asarray(pos, np.float64),
                                               np.asarray(quat), a)
            if self._allow(a, new_pos):
                self._teleport(new_pos, new_quat)
            return ArticulationAction()

        def get_obs(self):
            return {"finished": True}

    @BaseController.register("VlnMoveByFlashCollisionController")
    class VlnMoveByFlashCollisionController(VlnMoveByFlashController):  # noqa: F811
        """Flash teleport with top-down occupancy collision checks: a
        forward teleport is aborted when the target footprint intersects
        non-free space in the `topdown_camera_500` depth map
        (reference check_collision :139-160; free-space extraction and
        pixel transforms live in internnav_tpu/env/occupancy.py)."""

        def _allow(self, action, new_pos):
            if action != 1:
                return True
            cam = self.robot.sensors.get("topdown_camera_500")
            if cam is None:
                return True
            from internnav_tpu_torch.env.occupancy import make_occupancy_checker

            robot_type = "aliengo" \
                if "Aliengo" in getattr(self.robot.config, "type", "") else "h1"
            is_occupied = make_occupancy_checker(
                get_depth=lambda: np.asarray(cam.get_data()["depth"]),
                get_camera_xy=lambda: np.asarray(cam.get_world_pose()[0]),
                get_base_height=lambda: float(
                    self.robot.get_robot_base().get_world_pose()[0][2]),
                resolution=tuple(cam.resolution),
                robot_type=robot_type,
                get_ankle_height=(lambda: float(self.robot.get_ankle_height()))
                if robot_type == "aliengo" else None,
            )
            if is_occupied(float(new_pos[0]), float(new_pos[1])):
                from internnav_tpu_torch.utils.logging import get_logger

                get_logger("isaac_ext").info(
                    "[FLASH CONTROLLER]: collision detected, flash abort")
                return False
            return True

    _ = (VLNEvalTask, VLNCamera, VLNH1Robot, VlnMoveBySpeedController,
         StandStillController, DiscreteController,
         VlnMoveByFlashController, VlnMoveByFlashCollisionController)
    _REGISTERED = True
