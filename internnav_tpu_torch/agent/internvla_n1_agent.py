"""InternVLA-N1 dual-system agent — System-2 planner + System-1 actor.

Port of internnav_tpu/agent/internvla_n1_agent.py `InternVLAN1Agent` and
its `S2Mailbox`: an optional background System-2 thread fed through a
latest-wins mailbox, the 'partial_async' re-planning schedule (the one
every launcher and config uses), the look-down protocol, and System-1 on
the latent with the pixel-goal memory frame + current frame.

Deviation: the JAX agent turns any exception in System-2 into a STOP
action, which hides a kernel or device failure. Here an exception raised
by `s2_step` — in the background thread or inline — is re-raised by
`step()`, so the caller (e.g. the HTTP server, as a 500) sees it.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Union

import numpy as np

from internnav_tpu_torch.model.utils.vln_utils import S2Input, S2Output

LOOK_DOWN_ACTION = 5
S2Result = Union[S2Output, Exception]


class S2Mailbox:
    """SPSC mailbox: latest-wins request slot + result slot."""

    def __init__(self):
        self._req: "queue.Queue[S2Input]" = queue.Queue(maxsize=1)
        self._res: "queue.Queue[S2Result]" = queue.Queue(maxsize=1)

    @staticmethod
    def _replace(q: queue.Queue, item) -> None:
        try:  # the latest item wins
            q.get_nowait()
        except queue.Empty:
            pass
        q.put(item)

    def submit(self, item: S2Input) -> None:
        self._replace(self._req, item)

    def take_request(self, timeout: float = 0.1) -> Optional[S2Input]:
        try:
            return self._req.get(timeout=timeout)
        except queue.Empty:
            return None

    def publish(self, out: S2Result) -> None:
        self._replace(self._res, out)

    def poll(self) -> Optional[S2Result]:
        try:
            return self._res.get_nowait()
        except queue.Empty:
            return None

    def wait(self) -> S2Result:
        return self._res.get()


class InternVLAN1Agent:
    """Single-stream dual-system agent over an `InternVLAN1Policy`.

    async_s2: System-2 runs in a background thread (the robot keeps acting
    on queued actions meanwhile) or inline. sys2_max_forward_step: actions
    executed per System-2 plan before re-planning."""

    MAX_LOCAL_STEPS = 4     # actions taken from one System-1 call
    DEPTH_SCALE = 10.0      # raw depth units → metres
    DEPTH_CLIP_M = 5.0

    def __init__(self, policy, *, async_s2: bool = True, sys2_max_forward_step: int = 8):
        self.policy = policy
        self.async_s2 = async_s2
        self.sys2_max_forward_step = sys2_max_forward_step
        self.mailbox = S2Mailbox()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.reset()
        if self.async_s2:
            self._start_s2_thread()

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        self.policy.reset()
        self.action_queue: List[int] = []
        self.latent = None
        self.last_trajectory: Optional[np.ndarray] = None
        self.memory_frame: Optional[np.ndarray] = None
        self.steps_since_s2 = 0
        self.pending_s2 = False
        self.force_look_down = False

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _start_s2_thread(self) -> None:
        def run():
            while not self._stop.is_set():
                req = self.mailbox.take_request(timeout=0.1)
                if req is None:
                    continue
                try:
                    out: S2Result = self._infer_s2(req)
                except Exception as e:  # handed to step(), which re-raises it
                    out = e
                self.mailbox.publish(out)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    # -------------------------------------------------------------- helpers
    def _infer_s2(self, req: S2Input) -> S2Output:
        return self.policy.s2_step(req.rgb, req.instruction, look_down=req.look_down)

    def should_infer_s2(self) -> bool:
        if self.force_look_down:
            return True
        # re-plan when the budget is spent or nothing is queued
        return (self.steps_since_s2 >= self.sys2_max_forward_step
                or (len(self.action_queue) == 0 and self.latent is None))

    def _preprocess_depth(self, depth: np.ndarray) -> np.ndarray:
        d = np.asarray(depth, np.float32) * self.DEPTH_SCALE
        return np.clip(d, 0.0, self.DEPTH_CLIP_M)

    def _consume_s2(self, out: S2Result, obs: Dict[str, Any]) -> None:
        if isinstance(out, Exception):
            raise out
        if out.output_action:
            acts = list(out.output_action)
            if LOOK_DOWN_ACTION in acts:
                self.force_look_down = True
                acts = [a for a in acts if a != LOOK_DOWN_ACTION]
            self.action_queue.extend(acts)
            self.latent = None
        if out.output_latent is not None:
            self.latent = out.output_latent
            self.memory_frame = np.asarray(obs["rgb"])
        self.steps_since_s2 = 0

    def _run_s1(self, obs: Dict[str, Any]) -> None:
        rgb = np.asarray(obs["rgb"])
        mem = self.memory_frame if self.memory_frame is not None else rgb
        depth = obs.get("depth")
        depth2 = None
        if depth is not None:
            d = self._preprocess_depth(depth)
            if d.ndim == 2:
                d = d[..., None]
            depth2 = np.stack([d, d])[None]
        s1 = self.policy.s1_step_latent(np.stack([mem, rgb])[None], depth2, self.latent)
        self.last_trajectory = s1.trajectory
        self.action_queue.extend(s1.idx[: self.MAX_LOCAL_STEPS])

    # ------------------------------------------------------------------ api
    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        if len(obs) != 1:
            raise ValueError(f"the dual-system agent is single-stream, got {len(obs)} observations")
        o = obs[0]
        if self.should_infer_s2():
            req = S2Input(rgb=np.asarray(o["rgb"]), depth=o.get("depth"),
                          instruction=o.get("instruction_text", ""),
                          look_down=self.force_look_down)
            self.force_look_down = False
            if self.async_s2:
                self.mailbox.submit(req)
                self.pending_s2 = True
            else:
                self._consume_s2(self._infer_s2(req), o)

        if self.async_s2 and self.pending_s2:
            # block only when there is nothing else to execute
            if not self.action_queue and self.latent is None:
                res = self.mailbox.wait()
            else:
                res = self.mailbox.poll()
            if res is not None:
                self.pending_s2 = False
                self._consume_s2(res, o)

        if not self.action_queue and self.latent is not None:
            self._run_s1(o)

        action = self.action_queue.pop(0) if self.action_queue else 0
        self.steps_since_s2 += 1
        out: Dict[str, Any] = {"action": [int(action)]}
        if self.last_trajectory is not None:
            out["trajectory"] = self.last_trajectory
        return [out]
