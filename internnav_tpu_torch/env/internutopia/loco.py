"""H1 locomotion speed controller — the RL loco-policy port.

Reference parity: internnav/env/utils/internutopia_extension/controllers/
h1_vln_move_by_speed_controller.py (460 LoC):
- init_height_points (:20-50): 12x8 grid of body-frame sample points;
- DynamicHeightSamples (:83-204): expandable 0.1 m height map filled from
  point clouds, body points discarded, queried under yaw-rotated points;
- VlnMoveBySpeedController.forward (:299-435): builds the 492-dim policy
  observation (3-frame history window: old[66:396] + 162-dim current =
  [cmd*[2,2,.25], imu_ang_vel*.25, projected_gravity, (qpos-default),
  qvel*.05, old_actions, heights]), runs the torch.jit loco policy every
  4th substep (apply_times_left=3), scales actions by 0.25 and re-orders
  joints between isaac-gym and isaac-sim conventions.

Port of internnav_tpu/env/internutopia/loco.py. The policy is
`LocoActor`, the legged-gym actor (512-256-128, ELU) as an `nn.Module`
on an explicit device, randomly initialised from an explicit
`torch.Generator` (kinematics runs need no trained gait) or loaded from a
torch.jit checkpoint by `convert_loco_policy`; the JAX package's Flax
weights carry across with `model.weights.from_jax.loco_state_from_jax`.
The observation and the height map stay numpy, on the host. A
policy call copies the 492-float observation to the actor's device and
the 19 joint targets back (every 4th substep). `H1SpeedController` runs
the actor on the GPU unless the caller asks for the CPU: without a CUDA
device the default raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# joint orders (reference :227-269)
JOINT_NAMES_SIM = [
    "left_hip_yaw_joint", "right_hip_yaw_joint", "torso_joint",
    "left_hip_roll_joint", "right_hip_roll_joint",
    "left_shoulder_pitch_joint", "right_shoulder_pitch_joint",
    "left_hip_pitch_joint", "right_hip_pitch_joint",
    "left_shoulder_roll_joint", "right_shoulder_roll_joint",
    "left_knee_joint", "right_knee_joint",
    "left_shoulder_yaw_joint", "right_shoulder_yaw_joint",
    "left_ankle_joint", "right_ankle_joint",
    "left_elbow_joint", "right_elbow_joint",
]
JOINT_NAMES_GYM = [
    "left_hip_yaw_joint", "left_hip_roll_joint", "left_hip_pitch_joint",
    "left_knee_joint", "left_ankle_joint",
    "right_hip_yaw_joint", "right_hip_roll_joint", "right_hip_pitch_joint",
    "right_knee_joint", "right_ankle_joint",
    "torso_joint",
    "left_shoulder_pitch_joint", "left_shoulder_roll_joint",
    "left_shoulder_yaw_joint", "left_elbow_joint",
    "right_shoulder_pitch_joint", "right_shoulder_roll_joint",
    "right_shoulder_yaw_joint", "right_elbow_joint",
]
# default standing pose in SIM joint order (reference :374-396)
DEFAULT_DOF_POS = np.array(
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -0.4, -0.4, 0.0, 0.0,
     0.8, 0.8, 0.0, 0.0, -0.4, -0.4, 0.0, 0.0], np.float32,
)

SIM2GYM = np.array([JOINT_NAMES_SIM.index(n) for n in JOINT_NAMES_GYM])
GYM2SIM = np.array([JOINT_NAMES_GYM.index(n) for n in JOINT_NAMES_SIM])

OBS_FRAME_DIM = 162          # 3+3+3+19+19+19+96
POLICY_OBS_DIM = 492         # old[66:396] (330) + current frame (162)
NUM_JOINTS = 19
HIDDEN = (512, 256, 128)     # the legged-gym actor's hidden widths


def init_height_points() -> np.ndarray:
    """(96, 3) body-frame height sample points (reference :20-50)."""
    xs = np.array([-0.55, -0.45, -0.35, -0.25, -0.15, -0.05,
                   0.05, 0.15, 0.25, 0.35, 0.45, 0.55])
    ys = np.array([-0.35, -0.25, -0.15, -0.05, 0.05, 0.15, 0.25, 0.35])
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.zeros((gx.size, 3), np.float32)
    pts[:, 0] = gx.ravel()
    pts[:, 1] = gy.ravel()
    return pts


def quat_apply_yaw(quat_wxyz: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Rotate points by only the yaw component of a (w,x,y,z) quaternion."""
    w, x, y, z = np.asarray(quat_wxyz, np.float64).ravel()[:4]
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    c, s = np.cos(yaw), np.sin(yaw)
    out = np.array(points, np.float64)
    px, py = points[:, 0].copy(), points[:, 1].copy()
    out[:, 0] = c * px - s * py
    out[:, 1] = s * px + c * py
    return out


def quat_rotate_inverse(quat_wxyz: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """Rotate vec by the inverse of quat (w,x,y,z) — isaac math_utils parity."""
    q = np.asarray(quat_wxyz, np.float64).ravel()[:4]
    w, xyz = q[0], q[1:]
    v = np.asarray(vec, np.float64).ravel()[:3]
    a = v * (2.0 * w * w - 1.0)
    b = np.cross(xyz, v) * w * 2.0
    c = xyz * (xyz @ v) * 2.0
    return a - b + c


class DynamicHeightSamples:
    """Expandable 0.1 m-resolution terrain height map (reference :83-204)."""

    def __init__(self, resolution: float = 0.1):
        self.resolution = resolution
        self.x_min = self.x_max = self.y_min = self.y_max = None
        self.height_map: Optional[np.ndarray] = None

    def _adjust_range(self, x_min, x_max, y_min, y_max, padding: float):
        if self.x_min is None:
            self.x_min, self.x_max, self.y_min, self.y_max = x_min, x_max, y_min, y_max
            self.height_map = np.full(
                (x_max - x_min + 1, y_max - y_min + 1), padding, np.float32)
            return
        if x_min < self.x_min or x_max > self.x_max:
            pad_l = max(0, self.x_min - x_min)
            pad_r = max(0, x_max - self.x_max)
            self.height_map = np.pad(self.height_map, ((pad_l, pad_r), (0, 0)),
                                     constant_values=padding)
            self.x_min = min(self.x_min, x_min)
            self.x_max = max(self.x_max, x_max)
        if y_min < self.y_min or y_max > self.y_max:
            pad_t = max(0, self.y_min - y_min)
            pad_b = max(0, y_max - self.y_max)
            self.height_map = np.pad(self.height_map, ((0, 0), (pad_t, pad_b)),
                                     constant_values=padding)
            self.y_min = min(self.y_min, y_min)
            self.y_max = max(self.y_max, y_max)

    def set_heights(self, points: np.ndarray, robot_pos: np.ndarray) -> None:
        points = np.asarray(points, np.float64)
        rx, ry, rz = map(float, np.asarray(robot_pos).ravel()[:3])
        mask = (np.abs(points[:, 0] - rx) < 3.0) & (np.abs(points[:, 1] - ry) < 3.0)
        body = (np.abs(points[:, 0] - rx) < 0.5) & (np.abs(points[:, 1] - ry) < 0.5)
        pts = points[mask & ~body]
        if pts.size == 0:
            return
        px = np.floor(pts[:, 0] / self.resolution).astype(int)
        py = np.floor(pts[:, 1] / self.resolution).astype(int)
        self._adjust_range(px.min(), px.max(), py.min(), py.max(), rz)
        self.height_map[px - self.x_min, py - self.y_min] = pts[:, 2]

    def get_heights(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points, np.float64)
        if self.x_min is None:
            return np.zeros(points.shape[0], np.float32)
        px = np.floor(points[:, 0] / self.resolution).astype(int)
        py = np.floor(points[:, 1] / self.resolution).astype(int)
        ix = np.clip(px - self.x_min, 0, self.x_max - self.x_min)
        iy = np.clip(py - self.y_min, 0, self.y_max - self.y_min)
        return self.height_map[ix, iy]


@dataclasses.dataclass
class H1RobotState:
    """What the controller reads from the robot each substep — provided by
    Isaac (live articulation) or FakePhysicsVecEnv (kinematic stand-in)."""

    base_position: np.ndarray            # (3,) world
    torso_position: np.ndarray           # (3,) world
    torso_quat: np.ndarray               # (4,) wxyz
    imu_quat: np.ndarray                 # (4,) wxyz
    imu_ang_vel: np.ndarray              # (3,) world frame
    joint_positions: np.ndarray          # (19,) sim order
    joint_velocities: np.ndarray         # (19,) sim order
    ankle_height: float = 0.05
    pointcloud: Optional[np.ndarray] = None  # (N, 3) world


def loco_device(device=None) -> torch.device:
    """The device a loco actor runs on: the GPU unless `device` is the CPU
    (no CUDA device: raises)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    from internnav_tpu_torch import require_cuda

    return require_cuda(device)


class LocoActor(nn.Module):
    """The legged-gym actor 492 -> 512 -> 256 -> 128 -> 19 with ELU between
    the layers. Weights are drawn on the host from `generator` (seed 0 by
    default) as flax's Dense draws them (truncated normal of variance
    1/fan_in, zero bias), then moved to `device`, which is taken as given
    (`loco_device` resolves the default)."""

    def __init__(self, device="cpu", generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = [POLICY_OBS_DIM, *HIDDEN, NUM_JOINTS]
        layers = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            layer = nn.Linear(d_in, d_out)
            std = (1.0 / d_in) ** 0.5 / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                layer.bias.zero_()
            layers.append(layer)
        self.layers = nn.ModuleList(layers).to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = nn.functional.elu(layer(x))
        return self.layers[-1](x)


def convert_loco_policy(torch_jit_path: str, device=None) -> LocoActor:
    """torch.jit loco checkpoint (h1_loco_jit_policy.pt) -> a `LocoActor`
    on `device` (`loco_device`'s default: the GPU).

    Loads the Linear weights in graph order into the actor as they are
    (torch's (out, in) layout); raises ValueError if the checkpoint's
    layers differ from the (512, 256, 128) actor's.
    """
    device = loco_device(device)
    mod = torch.jit.load(torch_jit_path, map_location="cpu")
    params = list(mod.named_parameters())
    weights = [p.detach() for n, p in params if n.endswith("weight")]
    biases = [p.detach() for n, p in params if n.endswith("bias")]
    actor = LocoActor(device=device)
    want = [(tuple(l.weight.shape), tuple(l.bias.shape)) for l in actor.layers]
    got = [(tuple(w.shape), tuple(b.shape)) for w, b in zip(weights, biases)]
    if got != want or len(weights) != len(biases):
        raise ValueError(f"loco checkpoint {torch_jit_path}: layers {got}, the actor's {want}")
    with torch.no_grad():
        for layer, w, b in zip(actor.layers, weights, biases):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    return actor


class H1SpeedController:
    """VlnMoveBySpeedController parity: speed command -> joint targets."""

    def __init__(self, actor: Optional[LocoActor] = None, apply_times: int = 3,
                 device=None):
        """`actor`: the policy (several controllers may share one), on its
        own device; else a `LocoActor` of seed 0 on `device` (the GPU by
        default, the CPU when asked for)."""
        if actor is None:
            actor = LocoActor(device=loco_device(device))
        self.actor = actor
        self.device = next(actor.parameters()).device
        self._apply_times = apply_times
        #: the actor's forward calls (one every apply_times + 1 substeps)
        self.policy_calls = 0
        self.height_points = init_height_points()
        self.dynamic_height_samples = DynamicHeightSamples()
        self.reset()

    def reset(self) -> None:
        self._old_joint_positions = np.zeros(NUM_JOINTS, np.float32)
        self._old_policy_obs = np.zeros(POLICY_OBS_DIM, np.float32)
        self._apply_times_left = 0
        self._applied = DEFAULT_DOF_POS.copy()
        self._height_trigger = 0

    # ------------------------------------------------------------ obs build
    def build_obs(self, state: H1RobotState,
                  command: Tuple[float, float, float]) -> np.ndarray:
        """The exact 492-dim policy observation (reference :314-418)."""
        floor_h = state.ankle_height - 0.05
        if self._height_trigger == 0 and state.pointcloud is not None \
                and len(state.pointcloud) > 1:
            rp = state.base_position.copy().astype(np.float64)
            rp[2] = floor_h
            self.dynamic_height_samples.set_heights(state.pointcloud, rp)
        self._height_trigger = (self._height_trigger + 1) % 5

        pts_w = quat_apply_yaw(state.torso_quat, self.height_points) \
            + np.asarray(state.torso_position, np.float64)
        heights = self.dynamic_height_samples.get_heights(pts_w)
        heights = np.where(np.abs(heights - floor_h) > 0.2, floor_h, heights)
        heights = np.clip(state.torso_position[2] - 1.0 - heights, -1.0, 1.0) * 5.0

        imu_ang_vel = quat_rotate_inverse(state.imu_quat, state.imu_ang_vel)
        gravity = quat_rotate_inverse(state.imu_quat, np.array([0.0, 0.0, -1.0]))
        qpos = np.asarray(state.joint_positions, np.float32) - DEFAULT_DOF_POS
        qvel = np.asarray(state.joint_velocities, np.float32)

        fwd, lat, rot = command
        cmd = np.array([fwd, lat, rot], np.float32) * np.array([2.0, 2.0, 0.25])
        current = np.concatenate([
            cmd,                                        # 3
            imu_ang_vel * 0.25,                         # 3
            gravity,                                    # 3
            qpos[SIM2GYM],                              # 19
            qvel[SIM2GYM] * 0.05,                       # 19
            self._old_joint_positions[SIM2GYM],         # 19
            heights,                                    # 96
        ]).astype(np.float32)
        obs = np.concatenate([self._old_policy_obs[66:396], current])
        self._old_policy_obs = obs
        return obs

    # -------------------------------------------------------------- forward
    def forward(self, state: H1RobotState,
                forward_speed: float = 0.0, rotation_speed: float = 0.0,
                lateral_speed: float = 0.0) -> np.ndarray:
        """Joint position targets for one physics substep. The policy runs
        every (apply_times+1)-th substep; targets repeat in between."""
        if self._apply_times_left > 0:
            self._apply_times_left -= 1
            return self._applied
        obs = self.build_obs(state, (forward_speed, lateral_speed, rotation_speed))
        with torch.inference_mode():
            out = self.actor(torch.from_numpy(obs[None]).to(self.device))
        self.policy_calls += 1
        act_gym = out[0].cpu().numpy() * 0.25
        act_sim = act_gym[GYM2SIM]
        self._old_joint_positions = act_sim * 4.0
        self._applied = act_sim + DEFAULT_DOF_POS
        self._apply_times_left = self._apply_times
        return self._applied

    def action_to_control(self, state: H1RobotState,
                          action: Sequence[float]) -> np.ndarray:
        """(forward_speed, lateral_speed, rotation_speed) -> joint targets
        (reference action_to_control :437-455)."""
        assert len(action) == 3, "action must contain 3 elements"
        return self.forward(state, forward_speed=float(action[0]),
                            lateral_speed=float(action[1]),
                            rotation_speed=float(action[2]))

    def get_obs(self) -> Dict[str, Any]:
        return {"finished": True}
