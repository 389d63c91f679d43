"""Real-robot environment adapter.

Copy of internnav_tpu/realworld/env.py, kept in the port so that it
imports nothing of the JAX package (held equal to it by
tests/test_torch_host_copies.py); cv2 is imported only by the default
camera, built when no camera_fn is given.

Reference parity: internnav/env/realworld_agilex_env.py:10-82 (camera
capture thread + discrete action → velocity commands for the robot base)
and the agilex_extensions camera/control glue. Hardware I/O is injected
(`camera_fn`, `command_fn`) so the same env runs against a ROS bridge, the
HTTP robot server, or a recorded tape.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from internnav_tpu_torch.configs.evaluator import EnvCfg, TaskCfg
from internnav_tpu_torch.env.base import Env

ACTION_TO_VELOCITY = {
    0: (0.0, 0.0),
    1: (0.4, 0.0),   # forward
    2: (0.0, 0.6),   # turn left
    3: (0.0, -0.6),  # turn right
}


@Env.register("realworld")
class RealWorldEnv(Env):
    """env_settings:
    - camera_fn: () -> {"rgb": ..., "depth": ...} (required; a cv2
      VideoCapture-based default is built when camera_index is given)
    - command_fn: (v, w, duration_s) -> None (robot base command sink)
    - action_duration_s: per discrete action (default 1.0)
    - capture_hz: camera thread rate (default 10)
    """

    def __init__(self, env_cfg: EnvCfg, task_cfg: Optional[TaskCfg] = None):
        super().__init__(env_cfg, task_cfg)
        s = env_cfg.env_settings
        self.camera_fn: Callable = s.get("camera_fn") or self._make_cv2_camera(
            int(s.get("camera_index", 0)))
        self.command_fn: Callable = s.get("command_fn") or (lambda v, w, d: None)
        self.action_duration = float(s.get("action_duration_s", 1.0))
        self.capture_hz = float(s.get("capture_hz", 10))
        self._latest: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._steps = 0
        self._thread = threading.Thread(target=self._capture_loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _make_cv2_camera(index: int) -> Callable:
        import cv2

        cap = cv2.VideoCapture(index)

        def grab() -> Dict[str, Any]:
            ok, frame = cap.read()
            if not ok:
                raise RuntimeError("camera read failed")
            return {"rgb": cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)}

        return grab

    def _capture_loop(self) -> None:
        period = 1.0 / self.capture_hz
        while not self._stop.is_set():
            try:
                frame = self.camera_fn()
                with self._lock:
                    self._latest = frame
            except Exception:
                pass
            time.sleep(period)

    # ------------------------------------------------------------------ api
    def reset(self, env_ids: Optional[List[int]] = None):
        self._steps = 0
        self.command_fn(0.0, 0.0, 0.1)
        # wait for the first frame
        for _ in range(int(5 * self.capture_hz)):
            if self._latest is not None:
                break
            time.sleep(1.0 / self.capture_hz)
        return self.get_observation()

    def step(self, actions: List[Any]):
        a = int(actions[0] if not isinstance(actions[0], dict)
                else actions[0]["action"][0])
        v, w = ACTION_TO_VELOCITY.get(a, (0.0, 0.0))
        self.command_fn(v, w, self.action_duration)
        self._steps += 1
        return self.get_observation()

    def get_observation(self):
        with self._lock:
            frame = dict(self._latest) if self._latest else {}
        frame.setdefault("rgb", np.zeros((224, 224, 3), np.uint8))
        frame["steps"] = self._steps
        frame["done"] = False
        frame["finish_action"] = True
        return [frame]

    def close(self) -> None:
        self._stop.set()
        self.command_fn(0.0, 0.0, 0.1)
        super().close()
