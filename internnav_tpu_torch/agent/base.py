"""Agent base + registry.

Reference surface: internnav/agent/base.py:6-37 — `Agent.register`,
`Agent.init(cfg)`, abstract `step`/`reset`.

Copy of internnav_tpu/agent/base.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py). Unlike the original,
`Agent.init` imports the modules of `_LAZY_AGENT_MODULES` when it is asked
for a model_name that is not registered (the "dialog" agent), as
`Evaluator.init` does for its evaluators.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from internnav_tpu_torch.configs.agent import AgentCfg
from internnav_tpu_torch.utils.registry import Registry

agent_registry: Registry = Registry("agent")


class Agent:
    def __init__(self, cfg: AgentCfg):
        self.cfg = cfg

    register = staticmethod(agent_registry.register)

    #: modules whose import registers more agents ("dialog")
    _LAZY_AGENT_MODULES = ("internnav_tpu_torch.dialog.dialog_agent",)

    @classmethod
    def init(cls, cfg: AgentCfg) -> "Agent":
        if cfg.model_name not in agent_registry:
            import importlib

            for mod in cls._LAZY_AGENT_MODULES:
                importlib.import_module(mod)
        return agent_registry.build(cfg.model_name, cfg)

    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def reset(self, reset_index: Optional[List[int]] = None) -> None:
        raise NotImplementedError
