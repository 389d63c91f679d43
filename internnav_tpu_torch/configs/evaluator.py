"""Evaluation pipeline config schemas.

Mirrors the reference pydantic tree (internnav/configs/evaluator/__init__.py:1-80):
EnvCfg, SensorCfg, ControllerCfg, RobotCfg, SceneCfg, MetricCfg, TaskCfg,
EvalDatasetCfg, EvalCfg — with `extra='allow'` escape hatches preserved so
reference-style python config files load unchanged.

Copy of internnav_tpu/configs/evaluator.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import BaseModel, ConfigDict

from internnav_tpu_torch.configs.agent import AgentCfg


class _Cfg(BaseModel):
    model_config = ConfigDict(extra="allow")


class SensorCfg(_Cfg):
    name: str = "camera"
    type: str = "rgbd"
    resolution: List[int] = [256, 256]
    hfov: float = 90.0
    position: List[float] = [0.0, 0.0, 0.0]
    orientation: List[float] = [0.0, 0.0, 0.0]


class ControllerCfg(_Cfg):
    name: str = "discrete"
    type: str = "discrete"  # discrete | flash | speed | stand_still
    forward_distance: float = 0.25
    rotation_angle: float = 15.0
    steps_per_action: int = 50
    physics_frequency: int = 200


class RobotCfg(_Cfg):
    name: str = "h1"
    type: str = "humanoid"
    usd_path: Optional[str] = None
    controllers: List[ControllerCfg] = []
    sensors: List[SensorCfg] = []


class SceneCfg(_Cfg):
    scene_type: str = "mp3d"  # mp3d | grscene | kujiale
    scene_data_dir: Optional[str] = None
    scene_asset_path: Optional[str] = None


class MetricCfg(_Cfg):
    name: str = "vln_pe_metrics"
    success_distance: float = 3.0
    metric_setting: Dict[str, Any] = {}


class TaskCfg(_Cfg):
    task_name: str = "vln_eval"
    task_settings: Dict[str, Any] = {}
    scene: SceneCfg = SceneCfg()
    robot: Optional[RobotCfg] = None  # assembled by vln_default.get_config
    robot_name: str = "h1"
    robot_flash: bool = False
    robot_usd_path: Optional[str] = None
    camera_resolution: List[int] = [256, 256]
    camera_prim_path: Optional[str] = None
    metric_config: MetricCfg = MetricCfg()
    max_step: int = 200
    warm_up_step: int = 10
    one_step_stand_still: bool = False


class EvalDatasetCfg(_Cfg):
    dataset_type: str = "r2r"
    base_data_dir: Optional[str] = None
    split_data_types: List[str] = ["val_unseen"]
    filter_stairs: bool = True
    retry_list: List[str] = []
    # offline-replay fixture (TPU build addition): directory of recorded episodes
    replay_dir: Optional[str] = None
    max_episodes: Optional[int] = None


class EnvCfg(_Cfg):
    env_type: str = "fake"  # fake | habitat | internutopia | realworld
    env_settings: Dict[str, Any] = {}
    env_num: int = 1
    proc_num: int = 1


class EvalCfg(_Cfg):
    agent: AgentCfg = AgentCfg()
    env: EnvCfg = EnvCfg()
    task: TaskCfg = TaskCfg()
    dataset: EvalDatasetCfg = EvalDatasetCfg()
    eval_type: str = "vln_batched"
    eval_settings: Dict[str, Any] = {}
    use_agent_server: bool = False
    output_dir: str = "logs/eval"
    seed: int = 0


def merge_defaults(cfg: EvalCfg, defaults: Dict[str, Any]) -> EvalCfg:
    """Deep-merge `defaults` under `cfg` (cfg wins), mirroring the reference's
    defaults-merging get_config (configs/evaluator/vln_default_config.py:180-328).
    """

    def deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(base)
        for k, v in over.items():
            if k in out and isinstance(out[k], dict) and isinstance(v, dict):
                out[k] = deep_merge(out[k], v)
            elif v is not None:
                out[k] = v
        return out

    merged = deep_merge(defaults, cfg.model_dump(exclude_none=True, exclude_unset=True))
    return EvalCfg.model_validate(merged)


def validate_eval_config(cfg: EvalCfg, required: List[str]) -> None:
    """None-field validation on dotted paths (reference vln_default_config.py:106-177)."""
    for path in required:
        node: Any = cfg
        for part in path.split("."):
            node = getattr(node, part, None) if not isinstance(node, dict) else node.get(part)
            if node is None:
                raise ValueError(f"eval config field {path!r} is required but None")
