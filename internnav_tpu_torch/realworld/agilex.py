"""Agilex real-robot hardware glue (RealSense camera, ROS base control,
observation recording).

Copy of internnav_tpu/realworld/agilex.py, kept in the port so that it
imports nothing of the JAX package (held equal to it by
tests/test_torch_host_copies.py).

Reference parity: internnav/env/utils/agilex_extensions/ — `cam.py`
(AlignedRealSense: aligned color+depth capture with warmup), `control.py`
(ROS Twist yaw-tracked turns / distance-tracked moves), `save_obs.py`
(episode observation recorder), `stream.py` (MJPEG preview). Hardware
imports (pyrealsense2, rospy) are confined to the constructors so the
module imports anywhere; `RealWorldEnv` consumes these through its
injected camera_fn / command_fn.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class AlignedRealSense:
    """Aligned RGB-D capture (reference cam.py:11-120)."""

    def __init__(self, serial_no: Optional[str] = None,
                 color_res: Tuple[int, int, int] = (640, 480, 30),
                 depth_res: Tuple[int, int, int] = (640, 480, 30),
                 warmup_frames: int = 15):
        self.serial_no = serial_no
        self.color_res = color_res
        self.depth_res = depth_res
        self.warmup_frames = warmup_frames
        self.pipeline = None
        self.align = None
        self.depth_scale = None

    def start(self) -> None:
        import pyrealsense2 as rs

        self.pipeline = rs.pipeline()
        cfg = rs.config()
        if self.serial_no:
            cfg.enable_device(self.serial_no)
        cw, ch, cfps = self.color_res
        dw, dh, dfps = self.depth_res
        cfg.enable_stream(rs.stream.color, cw, ch, rs.format.bgr8, cfps)
        cfg.enable_stream(rs.stream.depth, dw, dh, rs.format.z16, dfps)
        profile = self.pipeline.start(cfg)
        self.depth_scale = float(
            profile.get_device().first_depth_sensor().get_depth_scale())
        self.align = rs.align(rs.stream.color)
        for _ in range(self.warmup_frames):
            self.pipeline.wait_for_frames()

    def capture(self) -> Dict[str, np.ndarray]:
        """→ {'rgb': (H, W, 3) uint8 RGB, 'depth': (H, W) float32 meters}."""
        frames = self.align.process(self.pipeline.wait_for_frames())
        color = np.asanyarray(frames.get_color_frame().get_data())[..., ::-1]
        depth = np.asanyarray(frames.get_depth_frame().get_data()).astype(
            np.float32) * self.depth_scale
        return {"rgb": np.ascontiguousarray(color), "depth": depth}

    def stop(self) -> None:
        if self.pipeline is not None:
            self.pipeline.stop()
            self.pipeline = None

    def as_camera_fn(self) -> Callable[[], Dict[str, np.ndarray]]:
        if self.pipeline is None:
            self.start()
        return self.capture


class RosBaseController:
    """cmd_vel publisher with odometry-tracked discrete motions (reference
    control.py Turn90Degrees generalized: track yaw/position from odom and
    stop when the target displacement is reached)."""

    def __init__(self, cmd_topic: str = "/cmd_vel",
                 odom_topic: str = "/ranger_base_node/odom", rate_hz: int = 10):
        import rospy
        from geometry_msgs.msg import Twist
        from nav_msgs.msg import Odometry

        self._rospy = rospy
        self._Twist = Twist
        self.pub = rospy.Publisher(cmd_topic, Twist, queue_size=10)
        self.current_yaw = 0.0
        self.current_xy = (0.0, 0.0)
        rospy.Subscriber(odom_topic, Odometry, self._odom_cb)
        self.rate = rospy.Rate(rate_hz)

    def _odom_cb(self, msg) -> None:
        o = msg.pose.pose.orientation
        siny = 2.0 * (o.w * o.z + o.x * o.y)
        cosy = 1.0 - 2.0 * (o.y * o.y + o.z * o.z)
        self.current_yaw = float(np.arctan2(siny, cosy))
        p = msg.pose.pose.position
        self.current_xy = (p.x, p.y)

    def command(self, v: float, w: float, duration_s: float) -> None:
        """Publish (v, w) for duration_s then stop — the RealWorldEnv
        command_fn surface."""
        t = self._Twist()
        t.linear.x = v
        t.angular.z = w
        end = time.time() + duration_s
        while time.time() < end and not self._rospy.is_shutdown():
            self.pub.publish(t)
            self.rate.sleep()
        self.pub.publish(self._Twist())  # stop

    def turn(self, angle_rad: float, angular_speed: float = 0.2) -> None:
        """Odometry-closed-loop turn (reference Turn90Degrees.execute_turn)."""
        start = self.current_yaw
        sign = 1.0 if angle_rad >= 0 else -1.0
        t = self._Twist()
        t.angular.z = sign * abs(angular_speed)
        while not self._rospy.is_shutdown():
            turned = np.arctan2(np.sin(self.current_yaw - start),
                                np.cos(self.current_yaw - start))
            if abs(turned) >= abs(angle_rad):
                break
            self.pub.publish(t)
            self.rate.sleep()
        self.pub.publish(self._Twist())

    def as_command_fn(self) -> Callable[[float, float, float], None]:
        return self.command


class ObsRecorder:
    """Episode observation recorder (reference save_obs.py): rgb as png,
    depth as npy, actions/poses as jsonl."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.step = 0
        self._meta = open(os.path.join(out_dir, "meta.jsonl"), "a")

    def save(self, obs: Dict[str, Any], action: Any = None,
             pose: Any = None) -> None:
        import cv2

        if "rgb" in obs:
            cv2.imwrite(os.path.join(self.out_dir, f"rgb_{self.step:05d}.png"),
                        np.asarray(obs["rgb"])[..., ::-1])
        if "depth" in obs:
            np.save(os.path.join(self.out_dir, f"depth_{self.step:05d}.npy"),
                    np.asarray(obs["depth"]))
        self._meta.write(json.dumps({
            "step": self.step,
            "action": action if action is None or isinstance(action, (int, float, str))
            else np.asarray(action).tolist(),
            "pose": None if pose is None else np.asarray(pose).tolist(),
            "time": time.time(),
        }) + "\n")
        self._meta.flush()
        self.step += 1

    def close(self) -> None:
        self._meta.close()
