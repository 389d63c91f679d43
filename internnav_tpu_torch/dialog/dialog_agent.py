"""Dialog navigation agent (IIGN / VL-LN).

Reference parity: internnav/agent/dialog_agent.py (~480 LoC): a
Qwen2.5-VL-driven agent that may ASK the NPC a question mid-episode
(model emits a question), incorporates the answer into the conversation,
parses actions or pixel goals, and converts pixel goals to GPS targets via
unprojection (dialog_agent.py:436 pixel→GPS).

Port of internnav_tpu/dialog/dialog_agent.py. Difference: without a policy
the agent builds the JAX agent's one (a tiny bf16 N1, or
model_settings["config"]) on model_settings["device"]: the GPU by default,
raising without one (no fallback to the host), "cpu" when asked for.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np

from internnav_tpu_torch.agent.base import Agent
from internnav_tpu_torch.configs.agent import AgentCfg
from internnav_tpu_torch.dialog.npc import SimpleNPC
from internnav_tpu_torch.model.utils.vln_utils import parse_actions
from internnav_tpu_torch.utils.geometry import camera_intrinsics, pixel_to_world


def pixel_to_gps(pixel_uv, depth_m: float, image_hw, hfov_deg: float,
                 agent_pose, camera_pitch_deg: float = -30.0) -> np.ndarray:
    """Unproject a pixel goal to world GPS (reference
    habitat_vln_evaluator.py:715-809 / dialog_agent.py:436): pinhole
    unprojection with a pitched camera, rotated into the agent frame."""
    h, w = image_hw
    K = camera_intrinsics(w, h, hfov_deg)
    pitch = np.deg2rad(camera_pitch_deg)
    x, y, yaw = agent_pose
    # camera frame: +z forward, +x right, +y down; tilt about the x axis
    cp, sp = np.cos(pitch), np.sin(pitch)
    cam_to_body = np.asarray([
        [0, sp, cp, 0],
        [-1, 0, 0, 0],
        [0, -cp, sp, 0],
        [0, 0, 0, 1],
    ], np.float64)
    cy, sy = np.cos(yaw), np.sin(yaw)
    body_to_world = np.asarray([
        [cy, -sy, 0, x],
        [sy, cy, 0, y],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ], np.float64)
    return pixel_to_world(pixel_uv, depth_m, K, body_to_world @ cam_to_body)


@Agent.register("dialog")
class DialogAgent(Agent):
    """Single-env dialog agent. model_settings:
    - goal_info: NPC annotation dict
    - max_questions (default 3)
    - config / system1: forwarded to the N1 policy
    - device: where that policy is built (the GPU when absent)
    """

    def __init__(self, cfg: AgentCfg, policy=None, npc: Optional[SimpleNPC] = None):
        super().__init__(cfg)
        settings = cfg.model_settings or {}
        if policy is None:
            import torch

            from internnav_tpu_torch import require_cuda
            from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
            from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

            n1_cfg = settings.get("config") or InternVLAN1Config.tiny(
                settings.get("system1", "nextdit_async"), dtype=torch.bfloat16)
            dev = settings.get("device")
            policy = InternVLAN1Policy.build(
                n1_cfg, device=torch.device("cpu") if dev == "cpu" else require_cuda(dev))
        self.policy = policy
        # npc_llm_fn: callable(prompt)->str — the reference phrases NPC
        # answers with an OpenAI call (habitat_dialog_evaluator.py:37-120);
        # inject any local LLM here, template answers are the fallback
        self.npc = npc or SimpleNPC(settings.get("goal_info", {}),
                                    llm_fn=settings.get("npc_llm_fn"),
                                    max_questions=int(settings.get("max_questions", 3)))
        self.hfov = float(settings.get("hfov", 90.0))
        self.dialog_context = ""
        self.action_queue: List[int] = []

    def reset(self, reset_index: Optional[List[int]] = None) -> None:
        self.policy.reset()
        self.npc.reset()
        self.dialog_context = ""
        self.action_queue = []

    # ------------------------------------------------------------------ api
    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        assert len(obs) == 1
        o = obs[0]
        # an evaluator-side NPC answer (oracle-backed) arrives as an obs key
        # on the step after an ASK (reference habitat_dialog_evaluator.py:202)
        if o.get("npc_answer"):
            self.dialog_context = (self.dialog_context + " " + str(o["npc_answer"])).strip()
        if self.action_queue:
            return [{"action": [self.action_queue.pop(0)], "ideal_flag": True}]

        instruction = o.get("instruction_text", "find the goal")
        if self.dialog_context:
            instruction = f"{instruction} Hint: {self.dialog_context}"
        out = self.policy.s2_step(np.asarray(o["rgb"]), instruction)
        text = self.policy.llm_output

        # question branch: relay to NPC, retry next step with the hint.
        # With a pre-digested goal_info the agent's own NPC answers inline;
        # otherwise the question is surfaced for the evaluator-side oracle
        # NPC, whose answer returns in the next obs as `npc_answer`.
        if "?" in text and not re.search(r"\d", text):
            out = {"action": [4], "ideal_flag": True, "question": text}
            if self.npc.goal:
                pose = o.get("pose") or [*np.asarray(o.get("globalgps", [0, 0, 0]))[:2],
                                         o.get("yaw", 0.0)]
                answer = self.npc.answer(text, agent_position=pose)
                self.dialog_context = (self.dialog_context + " " + answer).strip()
                out["answer"] = answer
            return [out]  # 4 = ask/no-op action

        if out.output_pixel is not None and "depth" in o:
            u, v = int(out.output_pixel[0]), int(out.output_pixel[1])
            depth = np.asarray(o["depth"])
            h, w = depth.shape[:2]
            u, v = np.clip(u, 0, w - 1), np.clip(v, 0, h - 1)
            d = float(depth[v, u]) if depth.ndim == 2 else float(depth[v, u, 0])
            pose = [*np.asarray(o.get("globalgps", [0, 0, 0]))[:2], o.get("yaw", 0.0)]
            gps = pixel_to_gps((u, v), max(d, 0.1), (h, w), self.hfov, pose)
            return [{"action": [1], "ideal_flag": True, "goal_gps": gps[:2].tolist()}]

        if out.output_action:
            self.action_queue = [a for a in out.output_action if a != 0][:4] or [0]
            return [{"action": [self.action_queue.pop(0)], "ideal_flag": True}]
        return [{"action": [0], "ideal_flag": True}]
