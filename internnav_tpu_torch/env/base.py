"""Environment base + registry.

Reference surface: internnav/env/base.py:6-54 — `Env.register`, `Env.init`,
reset/step/close/get_observation. Environments are vectorized (env_num
parallel episode slots) like the reference's InternUtopia vec env.

Copy of internnav_tpu/env/base.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from internnav_tpu_torch.configs.evaluator import EnvCfg, TaskCfg
from internnav_tpu_torch.utils.registry import Registry

env_registry: Registry = Registry("env")


class Env:
    """Base vectorized environment."""

    def __init__(self, env_cfg: EnvCfg, task_cfg: Optional[TaskCfg] = None):
        self.env_cfg = env_cfg
        self.task_cfg = task_cfg or TaskCfg()
        self.env_num = env_cfg.env_num
        self._is_running = True

    # -------------------------------------------------------------- registry
    register = staticmethod(env_registry.register)

    @classmethod
    def init(cls, env_cfg: EnvCfg, task_cfg: Optional[TaskCfg] = None) -> "Env":
        return env_registry.build(env_cfg.env_type, env_cfg, task_cfg)

    # ------------------------------------------------------------------- api
    @property
    def is_running(self) -> bool:
        return self._is_running

    def reset(self, env_ids: Optional[List[int]] = None) -> List[Optional[Dict[str, Any]]]:
        raise NotImplementedError

    def step(self, actions: List[Any]) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def get_observation(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def close(self) -> None:
        self._is_running = False
