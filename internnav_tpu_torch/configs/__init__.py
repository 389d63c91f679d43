"""Config schemas of the port (pydantic, copied from internnav_tpu.configs):
the agent and evaluation trees (`agent.py`, `evaluator.py`) and the
trainer's (`trainer.py`)."""

from internnav_tpu_torch.configs.agent import AgentCfg, InitRequest, ResetRequest, StepRequest
from internnav_tpu_torch.configs.evaluator import (
    ControllerCfg,
    EnvCfg,
    EvalCfg,
    EvalDatasetCfg,
    MetricCfg,
    RobotCfg,
    SceneCfg,
    SensorCfg,
    TaskCfg,
    merge_defaults,
    validate_eval_config,
)
from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg, MeshCfg, TrainEvalCfg

__all__ = [
    "AgentCfg", "InitRequest", "StepRequest", "ResetRequest", "EnvCfg", "EvalCfg",
    "EvalDatasetCfg", "TaskCfg", "SceneCfg", "SensorCfg", "ControllerCfg", "RobotCfg",
    "MetricCfg", "merge_defaults", "validate_eval_config", "ExpCfg", "IlCfg", "MeshCfg",
    "TrainEvalCfg",
]
