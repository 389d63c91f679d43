"""Agents of the port: the registry (`base.py`), the "simple" template
agent and the InternVLA-N1 dual-system agents ("internvla_n1",
"internvla_n1_batched")."""

from internnav_tpu_torch.agent.base import Agent, agent_registry
from internnav_tpu_torch.agent.internvla_n1_agent import BatchedInternVLAN1Agent, InternVLAN1Agent
from internnav_tpu_torch.agent.simple_agent import SimpleAgent

__all__ = ["Agent", "agent_registry", "BatchedInternVLAN1Agent", "InternVLAN1Agent",
           "SimpleAgent"]
