"""Agent + comm-server config schemas.

Reference: internnav/configs/agent/__init__.py:1-28 (AgentCfg,
InitRequest/StepRequest/ResetRequest).

Copy of internnav_tpu/configs/agent.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from pydantic import BaseModel, ConfigDict


class AgentCfg(BaseModel):
    model_config = ConfigDict(extra="allow")

    server_host: str = "localhost"
    server_port: int = 8023
    model_name: str = ""
    ckpt_path: str = ""
    model_settings: Dict[str, Any] = {}


class InitRequest(BaseModel):
    agent_config: Dict[str, Any]


class StepRequest(BaseModel):
    observation: str  # base64-encoded payload


class ResetRequest(BaseModel):
    reset_index: Optional[Any] = None
