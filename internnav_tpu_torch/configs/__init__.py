"""Config schemas of the port (pydantic, copied from internnav_tpu.configs):
the agent and evaluation trees (`agent.py`, `evaluator.py`), the model
tree and its per-policy defaults (`model.py`, `defaults/`), the VLN-PE
assembly (`vln_default.py`), the trainer's (`trainer.py`), and
`load_py_config`, which loads a python config file (`loader.py`)."""

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
from internnav_tpu_torch.configs.loader import load_py_config
from internnav_tpu_torch.configs.model import (
    BertCfg,
    CrossModalEncoderCfg,
    DiffusionPolicyCfg,
    ImageEncoderCfg,
    ImageEncoderDepthCfg,
    ImageEncoderRgbCfg,
    ImuEncoderCfg,
    ModelCfg,
    PrevActionEncoderCfg,
    ProgressMonitorCfg,
    StateEncoderCfg,
    StatePredictorCfg,
    TextEncoderCfg,
)
from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg, MeshCfg, TrainEvalCfg

__all__ = [
    "AgentCfg", "InitRequest", "StepRequest", "ResetRequest", "EnvCfg", "EvalCfg",
    "EvalDatasetCfg", "TaskCfg", "SceneCfg", "SensorCfg", "ControllerCfg", "RobotCfg",
    "MetricCfg", "merge_defaults", "validate_eval_config", "load_py_config", "ModelCfg",
    "TextEncoderCfg", "ImageEncoderCfg", "ImageEncoderRgbCfg", "ImageEncoderDepthCfg",
    "CrossModalEncoderCfg", "StateEncoderCfg", "ProgressMonitorCfg", "ImuEncoderCfg",
    "PrevActionEncoderCfg", "DiffusionPolicyCfg", "StatePredictorCfg", "BertCfg", "ExpCfg",
    "IlCfg", "MeshCfg", "TrainEvalCfg",
]
