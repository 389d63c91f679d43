"""Agents of the port: the registry (`base.py`), the "simple" template
agent, the InternVLA-N1 dual-system agents ("internvla_n1",
"internvla_n1_batched"), the recurrent CMA and Seq2Seq agents ("cma",
"seq2seq") and the VL-LN "dialog" agent
(`dialog/dialog_agent.py`), which registers itself on import: `Agent.init`
imports it when asked for a model_name it does not know, and this package
exposes `DialogAgent` lazily (the dialog package imports the evaluators,
which import this one)."""

from internnav_tpu_torch.agent.base import Agent, agent_registry
from internnav_tpu_torch.agent.internvla_n1_agent import BatchedInternVLAN1Agent, InternVLAN1Agent
from internnav_tpu_torch.agent.recurrent_agent import CmaAgent, Seq2SeqAgent
from internnav_tpu_torch.agent.simple_agent import SimpleAgent

__all__ = ["Agent", "agent_registry", "BatchedInternVLAN1Agent", "CmaAgent",
           "InternVLAN1Agent", "Seq2SeqAgent", "SimpleAgent", "DialogAgent"]


def __getattr__(name):
    if name == "DialogAgent":
        from internnav_tpu_torch.dialog.dialog_agent import DialogAgent

        return DialogAgent
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
