"""VLN-PE default-config assembly + validation.

Reference parity: internnav/configs/evaluator/vln_default_config.py:62-328 —
`get_config` completes a user EvalCfg for the VLN-PE evaluator: h1 robot
assembly (loco speed / stand-still / discrete controllers, pano camera,
point-cloud sensor, optional flash controller + topdown camera),
scene-type scale switch (mp3d 1:1, grscene/kujiale 1:100), per-model
model_settings defaults, deep merge over the framework defaults,
None-field validation, and distribution wiring.

Copy of internnav_tpu/configs/vln_default.py, kept in the port so that it imports
nothing of the JAX package (held equal to it by tests/test_torch_entry_points.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

from pydantic import BaseModel

from internnav_tpu_torch.configs.evaluator import (
    ControllerCfg,
    EnvCfg,
    EvalCfg,
    MetricCfg,
    RobotCfg,
    SceneCfg,
    SensorCfg,
    merge_defaults,
)

#: framework defaults (reference vln_default_config.py:62-103)
VLN_PE_DEFAULTS: Dict[str, Any] = {
    "env": {
        "env_type": "internutopia",
        "env_settings": {
            "sim_settings": {
                "physics_dt": 1 / 200,
                "rendering_dt": 1 / 200,
                "rendering_interval": 5,
                "use_fabric": True,
                "headless": True,
            },
            "offset_size": 100,
        },
    },
    "task": {
        "warm_up_step": 100,
        "metric_config": {"success_distance": 3.0},
    },
    "eval_settings": {"save_to_json": True, "vis_output": True},
}

SCENE_SCALES = {"mp3d": (1, 1, 1), "grscene": (0.01, 0.01, 0.01),
                "kujiale": (0.01, 0.01, 0.01)}


def validate_eval_config(cfg: BaseModel) -> bool:
    """Reject None leaves anywhere in the tree (reference
    validate_eval_config :106-138)."""

    #: fields that are None by design (TPU-build additions with optional
    #: semantics), not missing user configuration
    OPTIONAL = {"replay_dir", "max_episodes"}

    def walk(obj, path="") -> List[str]:
        """Recurse through declared model fields (dict escape hatches like
        env_settings/model_settings stay unchecked, as in the reference)."""
        bad: List[str] = []
        if isinstance(obj, BaseModel):
            for key in type(obj).model_fields:
                if key in OPTIONAL:
                    continue
                value = getattr(obj, key)
                p = f"{path}.{key}" if path else key
                if value is None:
                    bad.append(p)
                elif isinstance(value, BaseModel):
                    bad.extend(walk(value, p))
                elif isinstance(value, list):
                    for i, item in enumerate(value):
                        if item is None:
                            bad.append(f"{p}[{i}]")
                        elif isinstance(item, BaseModel):
                            bad.extend(walk(item, f"{p}[{i}]"))
        return bad

    none_fields = walk(cfg)
    if none_fields:
        raise ValueError("Evaluation config validation failed!\n"
                         + "\n".join(f" - {f}" for f in none_fields))
    return True


def _h1_robot(cfg: EvalCfg) -> RobotCfg:
    """The h1 robot assembly (reference :182-276)."""
    usd = cfg.task.robot_usd_path or ""
    loco_policy = (os.path.join(os.path.dirname(usd),
                                "policy/move_by_speed/h1_loco_jit_policy.pt")
                   if usd else "")
    speed = ControllerCfg(name="vln_move_by_speed",
                          type="VlnMoveBySpeedController",
                          policy_weights_path=loco_policy)
    stand = ControllerCfg(name="stand_still", type="StandStillController")
    discrete = ControllerCfg(name="move_by_discrete", type="DiscreteController",
                             steps_per_action=50, forward_distance=0.25,
                             rotation_angle=15.0, physics_frequency=200)
    controllers = [speed, stand, discrete]
    if cfg.task.robot_flash:
        flash_type = ("VlnMoveByFlashCollisionController"
                      if getattr(cfg.task, "flash_collision", False)
                      else "VlnMoveByFlashController")
        controllers.append(ControllerCfg(name="move_by_flash", type=flash_type))
    sensors = [SensorCfg(name="pano_camera_0", type="VLNCamera",
                         resolution=list(cfg.task.camera_resolution))]
    if cfg.task.robot_flash or cfg.eval_settings.get("vis_output", True):
        sensors.append(SensorCfg(name="topdown_camera_500", type="VLNCamera",
                                 resolution=[500, 500]))
    sensors.append(SensorCfg(name="tp_pointcloud", type="RepCamera",
                             resolution=[64, 64]))
    return RobotCfg(name="h1", type="VLNH1Robot", usd_path=usd,
                    controllers=controllers, sensors=sensors,
                    position=[0.0, 0.0, 1.05], ankle_height=0.0758,
                    fall_height_threshold=0.5)


def get_config(cfg: EvalCfg) -> EvalCfg:
    """Complete a user EvalCfg for VLN-PE evaluation (reference
    get_config :180-328)."""
    if cfg.task.robot_name != "h1":
        raise RuntimeError(f"unknown robot_name: {cfg.task.robot_name}")
    cfg = cfg.model_copy(deep=True)
    # optional asset paths default to empty strings so the None-leaf
    # validator only flags fields the user genuinely must set
    cfg.task.robot_usd_path = cfg.task.robot_usd_path or ""
    cfg.task.camera_prim_path = cfg.task.camera_prim_path or "pano_camera_0"
    if cfg.agent is not None:
        cfg.agent.ckpt_path = cfg.agent.ckpt_path or ""
    cfg.task.robot = _h1_robot(cfg)

    scene = cfg.task.scene
    scale = SCENE_SCALES.get(scene.scene_type)
    if scale is None:
        raise RuntimeError(f"unknown scene_type: {scene.scene_type}")
    cfg.task.scene = SceneCfg(scene_type=scene.scene_type,
                              scene_data_dir=scene.scene_data_dir or "",
                              scene_asset_path="", scene_scale=list(scale))

    # per-model model_settings defaults under the user's overrides
    if cfg.agent and cfg.agent.model_name:
        from internnav_tpu_torch.model import get_config as get_model_cfg

        try:
            defaults = get_model_cfg(cfg.agent.model_name).model_dump()
        except (KeyError, ValueError):
            defaults = {}
        defaults.update(cfg.agent.model_settings or {})
        cfg.agent.model_settings = defaults

    merged = merge_defaults(cfg, VLN_PE_DEFAULTS)
    # distribution wiring (Ray equivalent: the sim process pool)
    if cfg.env.proc_num and cfg.env.proc_num > 1:
        merged.env.env_settings.setdefault(
            "distribution_config", {"proc_num": cfg.env.proc_num})
    validate_eval_config(merged)
    return merged
