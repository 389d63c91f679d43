"""Isaac Sim / InternUtopia VLN-PE environment layer of the port.

- env.InternutopiaEnv: the registered "internutopia" env (Isaac backend
  import-guarded; "fake_physics" backend for simulator-free runs)
- vec_env.FakePhysicsVecEnv: kinematic vec env speaking the
  substep/finish_action protocol (VLNEvalTask semantics)
- loco: H1 locomotion controller (height scan + the `LocoActor` MLP)
- batch_adapter.VLNPEBatchAdapter: the batched obs-list protocol over one
  vec env (the pipelined evaluator's cohorts)
- isaac_ext: Isaac-side registrations (task/camera/robot/controllers)

Port of internnav_tpu/env/internutopia/.
"""

from internnav_tpu_torch.env.internutopia.env import InternutopiaEnv, import_extensions
from internnav_tpu_torch.env.internutopia.loco import (
    DynamicHeightSamples,
    H1RobotState,
    H1SpeedController,
    LocoActor,
    convert_loco_policy,
    init_height_points,
)
from internnav_tpu_torch.env.internutopia.vec_env import FakePhysicsVecEnv

__all__ = [
    "InternutopiaEnv", "import_extensions", "FakePhysicsVecEnv",
    "H1SpeedController", "H1RobotState", "DynamicHeightSamples",
    "init_height_points", "LocoActor", "convert_loco_policy",
]
