"""Trivial template agent (reference internnav/agent/simple_agent.py:11-53):
fixed or random actions; the SDK example and server smoke-test agent.

Copy of internnav_tpu/agent/simple_agent.py, kept in the port so that it
imports nothing of the JAX package."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from internnav_tpu_torch.agent.base import Agent
from internnav_tpu_torch.configs.agent import AgentCfg


@Agent.register("simple")
class SimpleAgent(Agent):
    def __init__(self, cfg: AgentCfg):
        super().__init__(cfg)
        settings = cfg.model_settings or {}
        self.mode = settings.get("mode", "fixed")  # fixed | random
        self.fixed_action = int(settings.get("action", 1))
        self.num_actions = int(settings.get("num_actions", 4))
        self.rng = np.random.RandomState(int(settings.get("seed", 0)))

    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        n = len(obs)
        if self.mode == "random":
            acts = self.rng.randint(0, self.num_actions, size=n)
        else:
            acts = np.full((n,), self.fixed_action)
        return [{"action": [int(a)], "ideal_flag": True} for a in acts]

    def reset(self, reset_index: Optional[List[int]] = None) -> None:
        pass
