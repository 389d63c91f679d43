"""Real-robot trajectory-following controllers (host-side numpy).

Copy of internnav_tpu/realworld/controllers.py, kept in the port so that
it imports nothing of the JAX package.

Reference parity: scripts/realworld/controllers.py:14-188 — a PID heading/
speed controller and an MPC reference-tracking controller for following
the System-1 waypoint trajectories on the physical robot (Agilex/Unitree).
casadi isn't available here; the MPC solves the same unicycle
reference-tracking problem by finite-horizon iterative linearization
(discrete LQR sweep), which converges to the same tracking behavior for
the short horizons used (≤ 8 steps).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from internnav_tpu_torch.utils.geometry import wrap_angle


@dataclass
class PIDController:
    """Heading + speed PID producing (v, w) from the next waypoint."""

    kp_lin: float = 1.0
    kp_ang: float = 2.0
    ki_ang: float = 0.0
    kd_ang: float = 0.1
    max_v: float = 0.5
    max_w: float = 1.0
    dt: float = 0.1
    _int: float = field(default=0.0, repr=False)
    _prev_err: float = field(default=0.0, repr=False)

    def reset(self) -> None:
        self._int = 0.0
        self._prev_err = 0.0

    def step(self, pose: Sequence[float], target_xy: Sequence[float]) -> Tuple[float, float]:
        """pose = (x, y, yaw) → (v, w)."""
        x, y, yaw = pose
        dx, dy = target_xy[0] - x, target_xy[1] - y
        dist = float(np.hypot(dx, dy))
        err = float(wrap_angle(np.arctan2(dy, dx) - yaw))
        self._int += err * self.dt
        derr = (err - self._prev_err) / self.dt
        self._prev_err = err
        w = self.kp_ang * err + self.ki_ang * self._int + self.kd_ang * derr
        # slow down when misaligned (reference behavior)
        v = self.kp_lin * dist * max(np.cos(err), 0.0)
        return float(np.clip(v, 0, self.max_v)), float(np.clip(w, -self.max_w, self.max_w))


@dataclass
class MPCController:
    """Receding-horizon unicycle tracking via iterative LQR."""

    horizon: int = 8
    dt: float = 0.2
    q_pos: float = 4.0
    q_yaw: float = 0.5
    r_v: float = 0.1
    r_w: float = 0.1
    max_v: float = 0.6
    max_w: float = 1.2
    iters: int = 3

    def step(self, pose: Sequence[float], reference: np.ndarray) -> Tuple[float, float]:
        """pose (x, y, yaw); reference (K, 2) waypoints → first (v, w)."""
        ref = np.asarray(reference, np.float64)
        H = min(self.horizon, len(ref))
        if H == 0:
            return 0.0, 0.0
        ref = ref[:H]
        u = np.zeros((H, 2))  # (v, w) sequence
        x0 = np.asarray(pose, np.float64)
        for _ in range(self.iters):
            xs = self._rollout(x0, u)
            # backward sweep: linearize and solve a Riccati recursion
            u = self._lqr_update(xs, u, ref)
            u[:, 0] = np.clip(u[:, 0], 0.0, self.max_v)
            u[:, 1] = np.clip(u[:, 1], -self.max_w, self.max_w)
        return float(u[0, 0]), float(u[0, 1])

    def _rollout(self, x0, u):
        xs = [np.asarray(x0, np.float64)]
        for v, w in u:
            x, y, th = xs[-1]
            xs.append(np.asarray([
                x + v * np.cos(th) * self.dt,
                y + v * np.sin(th) * self.dt,
                wrap_angle(th + w * self.dt),
            ]))
        return np.stack(xs)

    def _lqr_update(self, xs, u, ref):
        H = len(u)
        Q = np.diag([self.q_pos, self.q_pos, self.q_yaw])
        R = np.diag([self.r_v, self.r_w])
        S = Q.copy()
        s_vec = Q @ self._err(xs[H], ref[H - 1])
        Ks: List[np.ndarray] = [None] * H
        ks: List[np.ndarray] = [None] * H
        for t in range(H - 1, -1, -1):
            A, B = self._jacobians(xs[t], u[t])
            err = self._err(xs[t], ref[min(t, H - 1)])
            Quu = R + B.T @ S @ B
            Qux = B.T @ S @ A
            qu = R @ u[t] + B.T @ s_vec
            Kt = np.linalg.solve(Quu, Qux)
            kt = np.linalg.solve(Quu, qu)
            Ks[t], ks[t] = Kt, kt
            S = Q + A.T @ S @ A - Qux.T @ Kt
            s_vec = Q @ err + (A - B @ Kt).T @ s_vec
        # forward pass
        new_u = u.copy()
        x = xs[0]
        for t in range(H):
            dx = x - xs[t]
            dx[2] = wrap_angle(dx[2])
            new_u[t] = u[t] - ks[t] - Ks[t] @ dx
            x = self._rollout(x, new_u[t : t + 1])[-1]
        return new_u

    def _jacobians(self, x, u):
        _, _, th = x
        v, _ = u
        A = np.eye(3)
        A[0, 2] = -v * np.sin(th) * self.dt
        A[1, 2] = v * np.cos(th) * self.dt
        B = np.zeros((3, 2))
        B[0, 0] = np.cos(th) * self.dt
        B[1, 0] = np.sin(th) * self.dt
        B[2, 1] = self.dt
        return A, B

    @staticmethod
    def _err(x, ref_xy):
        return np.asarray([x[0] - ref_xy[0], x[1] - ref_xy[1], 0.0])


def trajectory_to_vw(trajectory: np.ndarray, pose=(0.0, 0.0, 0.0),
                     controller: Optional[MPCController] = None) -> Tuple[float, float]:
    """S1 waypoint trajectory → immediate (v, w) command (reference
    trajectory_tovw used by the realworld async agent).

    `trajectory` is in the ROBOT frame (System-1 waypoints always are);
    the controllers' cost runs in absolute odom coordinates, so the path
    is rotated by the robot's yaw and translated to its position first.
    The reference's own controller is pose-free proportional control on
    the robot-frame subgoal (internvla_n1_agent_realworld.py:120-125) —
    equivalent at pose (0, 0, 0), frame-correct everywhere else."""
    controller = controller or MPCController()
    local_xy = np.asarray(trajectory, np.float32)[:, :2]
    x0, y0, yaw = (float(pose[0]), float(pose[1]), float(pose[2]))
    c, s = np.cos(yaw), np.sin(yaw)
    world_xy = np.stack([
        x0 + c * local_xy[:, 0] - s * local_xy[:, 1],
        y0 + s * local_xy[:, 0] + c * local_xy[:, 1],
    ], axis=1)
    return controller.step(pose, world_xy)
