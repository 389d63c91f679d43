"""Robot-side client loop for the real-world InternVLA-N1 HTTP server.

The port's copy of scripts/realworld/http_internvla_client.py, on the
port's realworld controllers and server wire format (it imports nothing
of the JAX package).

Reference parity: scripts/realworld/http_internvla_client.py:1-362 — a
ROS2 node that synchronizes RGB-D + odometry, posts frames to the
inference server, and follows the returned trajectory with an MPC (or
PID) controller publishing `Twist` commands. This client speaks OUR
server's wire format (internnav_tpu_torch/realworld/server.py: JSON
with base64-encoded .npy arrays on `/eval_dual`, `/reset`) and reuses
the framework's controllers (internnav_tpu_torch/realworld/controllers.py)
instead of the reference's vendored MPC/PID.

ROS2 (rclpy / cv_bridge / message_filters) is imported lazily inside
`RosClientNode` — on a machine without ROS the `--dry-run` mode drives
the identical request/control path with synthetic frames, which is also
how tests/test_torch_robot_scripts.py exercises this script headlessly.

Usage (robot):
    python scripts/torch/realworld/http_internvla_client.py \
        --url http://<server>:5801 --instruction "go to the kitchen" \
        --controller mpc
Usage (headless smoke):
    python scripts/torch/realworld/http_internvla_client.py --dry-run --steps 3
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from pathlib import Path
from typing import Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

import numpy as np  # noqa: E402

from internnav_tpu_torch.realworld.controllers import (  # noqa: E402
    MPCController,
    PIDController,
    trajectory_to_vw,
)
from internnav_tpu_torch.realworld.server import encode_npy  # noqa: E402


class DualSystemClient:
    """HTTP + control-loop core, transport-agnostic (no ROS imports).

    One `step(rgb, depth, pose)` = POST the frame, convert the returned
    trajectory (or discrete action) into a (v, w) command via the chosen
    controller — the reference's `dual_sys_eval` + control-mode switch
    (http_internvla_client.py:52-120) on our wire format."""

    def __init__(self, url: str, instruction: str,
                 controller: str = "mpc",
                 http_fn=None, timeout_s: float = 30.0):
        self.url = url.rstrip("/")
        self.instruction = instruction
        self.controller_name = controller
        self.timeout_s = timeout_s
        self.mpc = MPCController()
        self.pid = PIDController()
        self.last_trajectory: Optional[np.ndarray] = None
        self.step_idx = -1
        # injectable transport for tests / dry-run against an in-process
        # server
        self._http = http_fn or self._urllib_post

    # ------------------------------------------------------------ transport
    def _urllib_post(self, route: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.url + route, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    def reset(self) -> None:
        self._http("/reset", {})
        self.last_trajectory = None
        self.step_idx = -1
        self.pid.reset()

    # -------------------------------------------------------------- control
    def step(self, rgb: np.ndarray, depth: Optional[np.ndarray],
             pose: Tuple[float, float, float]) -> Tuple[float, float, dict]:
        """Returns (v, w, raw_response)."""
        self.step_idx += 1
        body = {
            "instruction": self.instruction,
            "rgb": encode_npy(np.asarray(rgb, np.uint8)),
            "depth": encode_npy(np.asarray(depth, np.float32))
            if depth is not None else None,
            "pose": list(map(float, pose)),
        }
        out = self._http("/eval_dual", body)
        traj = out.get("trajectory")
        if traj:
            # server returns per-step (dx, dy, dyaw) deltas in the ROBOT
            # frame; integrate to a robot-frame path. trajectory_to_vw
            # transforms it into the odom frame against `pose` before the
            # MPC tracks it; the PID branch transforms its subgoal here.
            self.last_trajectory = np.asarray(traj, np.float32)
            local_xy = np.cumsum(self.last_trajectory[:, :2] / 4.0, axis=0)
            if self.controller_name == "mpc":
                v, w = trajectory_to_vw(local_xy, pose, self.mpc)
            else:
                gx, gy = local_xy[min(1, len(local_xy) - 1)]
                x0, y0, yaw = map(float, pose)
                c, s = np.cos(yaw), np.sin(yaw)
                target = (x0 + c * gx - s * gy, y0 + s * gx + c * gy)
                v, w = self.pid.step(pose, target)
        else:
            v, w = float(out.get("v", 0.0)), float(out.get("w", 0.0))
        return v, w, out


def run_dry(steps: int, url: str, instruction: str, controller: str) -> None:
    """Headless smoke: an in-process fake server answers the exact wire
    format, so the full request->trajectory->controller path runs without
    ROS or a robot."""

    def fake_http(route: str, body: dict) -> dict:
        if route == "/reset":
            return {"status": "ok"}
        assert "rgb" in body and "instruction" in body
        traj = [[0.25, 0.0, 0.0]] * 4
        return {"action": [1], "v": 0.4, "w": 0.0, "trajectory": traj}

    client = DualSystemClient(url, instruction, controller, http_fn=fake_http)
    client.reset()
    pose = (0.0, 0.0, 0.0)
    rs = np.random.RandomState(0)
    for t in range(steps):
        rgb = rs.randint(0, 255, (480, 640, 3)).astype(np.uint8)
        depth = rs.uniform(0.1, 5.0, (480, 640)).astype(np.float32)
        v, w, _ = client.step(rgb, depth, pose)
        print(f"step {t}: v={v:.3f} w={w:.3f}")
        pose = (pose[0] + 0.1 * v, pose[1], pose[2] + 0.1 * w)
    print("dry-run ok")


class RosClientNode:
    """ROS2 wrapper: synchronized RGB-D subscriber + odom + Twist publisher
    around DualSystemClient (reference node structure; rclpy imported here
    so the module stays importable without ROS)."""

    def __init__(self, client: DualSystemClient, rate_hz: float = 2.0,
                 rgb_topic: str = "/camera/color/image_raw",
                 depth_topic: str = "/camera/depth/image_rect_raw",
                 odom_topic: str = "/odom",
                 cmd_topic: str = "/cmd_vel"):
        import rclpy
        from cv_bridge import CvBridge
        from geometry_msgs.msg import Twist
        from message_filters import ApproximateTimeSynchronizer, Subscriber
        from nav_msgs.msg import Odometry
        from rclpy.node import Node
        from sensor_msgs.msg import Image

        rclpy.init()
        self._rclpy = rclpy
        self.client = client
        self.bridge = CvBridge()
        self.node: "Node" = Node("internvla_n1_client")
        self.pub = self.node.create_publisher(Twist, cmd_topic, 10)
        self._twist_cls = Twist
        self.latest = {"rgb": None, "depth": None, "pose": (0.0, 0.0, 0.0)}

        rgb_sub = Subscriber(self.node, Image, rgb_topic)
        depth_sub = Subscriber(self.node, Image, depth_topic)
        sync = ApproximateTimeSynchronizer([rgb_sub, depth_sub], 10, 0.1)
        sync.registerCallback(self._on_frames)
        self.node.create_subscription(Odometry, odom_topic, self._on_odom, 10)
        self.node.create_timer(1.0 / rate_hz, self._on_tick)

    def _on_frames(self, rgb_msg, depth_msg):
        self.latest["rgb"] = self.bridge.imgmsg_to_cv2(rgb_msg, "rgb8")
        self.latest["depth"] = self.bridge.imgmsg_to_cv2(
            depth_msg, "passthrough").astype(np.float32)

    def _on_odom(self, msg):
        q = msg.pose.pose.orientation
        yaw = float(np.arctan2(2 * (q.w * q.z + q.x * q.y),
                               1 - 2 * (q.y * q.y + q.z * q.z)))
        p = msg.pose.pose.position
        self.latest["pose"] = (float(p.x), float(p.y), yaw)

    def _on_tick(self):
        if self.latest["rgb"] is None:
            return
        # the HTTP call blocks this single-threaded executor (odom/image
        # callbacks starve during inference) — on any failure or timeout,
        # publish a zero Twist so a hung server cannot leave the robot
        # executing the last nonzero command
        try:
            v, w, _ = self.client.step(self.latest["rgb"],
                                       self.latest["depth"],
                                       self.latest["pose"])
        except Exception as e:
            self.node.get_logger().warning(f"inference step failed: {e!r}")
            v, w = 0.0, 0.0
        cmd = self._twist_cls()
        cmd.linear.x = float(v)
        cmd.angular.z = float(w)
        self.pub.publish(cmd)

    def spin(self):
        try:
            self._rclpy.spin(self.node)
        finally:
            self.node.destroy_node()
            self._rclpy.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://127.0.0.1:5801")
    ap.add_argument("--instruction", default="walk forward and stop")
    ap.add_argument("--controller", choices=("mpc", "pid"), default="mpc")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="control-loop frequency (Hz)")
    ap.add_argument("--dry-run", action="store_true",
                    help="no ROS / no network: fake frames through the "
                         "full client path")
    ap.add_argument("--steps", type=int, default=3, help="dry-run steps")
    args = ap.parse_args()

    if args.dry_run:
        run_dry(args.steps, args.url, args.instruction, args.controller)
        return
    client = DualSystemClient(args.url, args.instruction, args.controller)
    client.reset()
    RosClientNode(client, rate_hz=args.rate).spin()


if __name__ == "__main__":
    main()
