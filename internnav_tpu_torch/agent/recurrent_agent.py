"""Batched recurrent agents (CMA "cma", Seq2Seq "seq2seq").

Port of internnav_tpu/agent/recurrent_agent.py (reference
internnav/agent/cma_agent.py:14-138, seq2seq_agent.py): per-env RNN states
(N, layers, H), prev_actions (N,) and not-done masks (N,); `reset` zeroes
the given envs' slices (the reference's index_fill_); instructions padded
to 200 tokens; depth resized to 256x256 (nearest) and RGB to 224x224
(bilinear) when they arrive at another size; the policy runs
mode="inference" (argmax), and each env's output is
{"action": [a], "ideal_flag": True}.

The states stay on the policy's device between steps (a reset writes
zeros there), so a step uploads the observations and fetches only the
actions. `step_coroutine` yields while the forward runs on the device.
The policy is built on the GPU unless model_settings["device"] (eval.py's
--device) asks for the CPU; there is no fallback. A policy handed in
(`policy=`) is shared: pipelined cohorts share cohort 0's, each with its
own states.

The resizes are cv2's (`cv2.resize` in the JAX agent) without cv2:
INTER_NEAREST takes source index floor(x · (1 / (dst / src))), INTER_LINEAR
on float32 is the half-pixel bilinear of torch's `interpolate`
(align_corners False, no antialias).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from internnav_tpu_torch.agent.base import Agent
from internnav_tpu_torch.configs.agent import AgentCfg
from internnav_tpu_torch.model import get_config, get_policy
from internnav_tpu_torch.model.base import resolve_device
from internnav_tpu_torch.model.basemodel.cma import DEPTH_HW, RGB_HW
from internnav_tpu_torch.utils.misc import batch_obs, tree_device_put


def resize_nearest(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST) for an (H, W)
    or (H, W, C) array."""
    def index(dst: int, src: int) -> np.ndarray:
        inv = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)

    return img[index(hw[0], img.shape[0])][:, index(hw[1], img.shape[1])]


def resize_bilinear(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) for a float32
    (H, W, C) array."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(hw), mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


class _RecurrentAgentBase(Agent):
    policy_name = ""
    #: the frame sizes of the policy (reference observation space)
    rgb_size = (RGB_HW, RGB_HW)
    depth_size = (DEPTH_HW, DEPTH_HW)
    instr_pad_len = 200

    def __init__(self, cfg: AgentCfg, policy=None):
        super().__init__(cfg)
        settings = dict(cfg.model_settings or {})
        model_cfg = get_config(self.policy_name)
        for k, v in settings.items():
            if k != "device":
                setattr(model_cfg, k, v)
        if policy is not None:
            self.policy = policy
        else:
            policy_cls = get_policy(self.policy_name)
            device = resolve_device(settings.get("device"))
            if cfg.ckpt_path:
                self.policy = policy_cls.from_pretrained(cfg.ckpt_path, cfg=model_cfg,
                                                         device=device)
            else:
                self.policy = policy_cls.build(model_cfg, device=device)
        self.model_cfg = model_cfg
        self.hidden_size = model_cfg.state_encoder.hidden_size
        self.num_layers = self.policy.num_recurrent_layers()
        self._states: Optional[torch.Tensor] = None
        self._prev_actions: Optional[torch.Tensor] = None
        self._not_done: Optional[torch.Tensor] = None

    def _ensure_state(self, n: int) -> None:
        if self._states is None or self._states.shape[0] != n:
            dev = self.policy.device
            self._states = torch.zeros((n, self.num_layers, self.hidden_size), device=dev)
            self._prev_actions = torch.zeros((n,), dtype=torch.long, device=dev)
            self._not_done = torch.zeros((n,), device=dev)  # 0 → an episode's first step

    def reset(self, reset_index: Optional[List[int]] = None) -> None:
        if self._states is None:
            return
        idx = slice(None) if reset_index is None else torch.as_tensor(
            list(reset_index), dtype=torch.long, device=self._states.device)
        self._states[idx] = 0
        self._prev_actions[idx] = 0
        self._not_done[idx] = 0

    def _build_observations(self, obs: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        fields = []
        for o in obs:
            instr = np.asarray(o["instruction"], np.int32)
            padded = np.zeros((self.instr_pad_len,), np.int32)
            padded[: min(len(instr), self.instr_pad_len)] = instr[: self.instr_pad_len]
            depth = np.asarray(o["depth"], np.float32)
            if depth.ndim == 3:
                depth = depth[..., 0]
            if depth.shape != tuple(self.depth_size):
                depth = resize_nearest(depth, self.depth_size)
            rgb = np.asarray(o["rgb"], np.float32)
            if rgb.shape[:2] != tuple(self.rgb_size):
                rgb = resize_bilinear(rgb, self.rgb_size)
            fields.append({"instruction": padded, "rgb": rgb, "depth": depth[..., None]})
        return batch_obs(fields)

    def step_coroutine(self, obs: List[Dict[str, Any]]):
        """Generator form of `step` for pipelined evaluation: the forward
        is queued on the device, then the generator yields so that a
        scheduler runs other cohorts' host work while it executes; the
        actions are fetched after the resume."""
        n = len(obs)
        self._ensure_state(n)
        batch = {
            "observations": tree_device_put(self._build_observations(obs), self.policy.device),
            "rnn_states": self._states,
            "prev_actions": self._prev_actions,
            "masks": self._not_done,
            "mode": "inference",
        }
        actions, states, _ = self.policy.forward(batch)
        yield  # device busy: the recurrent forward in flight
        actions = actions.reshape(n)
        self._states = states
        self._prev_actions = actions
        self._not_done = torch.ones_like(self._not_done)
        return [{"action": [int(a)], "ideal_flag": True} for a in actions.tolist()]

    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        gen = self.step_coroutine(obs)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value


@Agent.register("cma")
class CmaAgent(_RecurrentAgentBase):
    policy_name = "CMA_Policy"


@Agent.register("seq2seq")
class Seq2SeqAgent(_RecurrentAgentBase):
    policy_name = "Seq2Seq_Policy"
