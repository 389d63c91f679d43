"""Agents of the port: the registry (`base.py`) and the InternVLA-N1
dual-system agents."""

from internnav_tpu_torch.agent.base import Agent, agent_registry
from internnav_tpu_torch.agent.internvla_n1_agent import BatchedInternVLAN1Agent, InternVLAN1Agent

__all__ = ["Agent", "agent_registry", "BatchedInternVLAN1Agent", "InternVLAN1Agent"]
