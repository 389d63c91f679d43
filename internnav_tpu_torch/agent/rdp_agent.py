"""RDP agent: continuous diffusion-policy inference with waypoint caches.

Port of internnav_tpu/agent/rdp_agent.py (reference
internnav/agent/rdp_agent.py:267-353): per-env RNN states and a per-env
cache of predicted waypoints. Every step runs mode "update_rnn"; when any
env's cache is empty, mode "act" denoises a trajectory of len_traj_pred
waypoints for every env, and each empty cache takes the first
len_traj_act, popped one a step. An env whose act call's stop-progress
exceeds `stop_threshold` (model_settings, 0.85) STOPs; otherwise its
waypoint maps to a discrete action (`_waypoint_to_discrete`). The
prev-action window holds the last len_traj_act waypoints, newest first.

Instructions are padded to 80 tokens with RoBERTa's pad id 1; depth is
resized to 256x256 (nearest) and RGB to 224x224 (bilinear) when they
arrive at another size, without cv2 (`recurrent_agent.resize_*`). The RNN
states and masks stay on the policy's device between steps (a reset writes
zeros there); the observations and the prev-action window (built on the
host from the cached waypoints) are uploaded each step, the trajectory
and stop-progress fetched after an act. The policy is built on the GPU
unless model_settings["device"] asks for the CPU (no fallback); an act
call's draws come from the policy's generator, seeded with
model_settings["seed"] (0), or from `draw_fn(n)` when one is set (the
parity tests hand in JAX's). A policy handed in (`policy=`) is shared,
with its config.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from internnav_tpu_torch.agent.base import Agent
from internnav_tpu_torch.agent.recurrent_agent import resize_bilinear, resize_nearest
from internnav_tpu_torch.configs.agent import AgentCfg
from internnav_tpu_torch.model import get_config, get_policy
from internnav_tpu_torch.model.base import resolve_device
from internnav_tpu_torch.model.basemodel.rdp import DEPTH_HW, RGB_HW
from internnav_tpu_torch.utils.misc import batch_obs, tree_device_put


@Agent.register("rdp")
class RdpAgent(Agent):
    instr_pad_len = 80

    def __init__(self, cfg: AgentCfg, policy=None):
        super().__init__(cfg)
        settings = dict(cfg.model_settings or {})
        model_cfg = get_config("rdp")
        for k, v in settings.items():
            if k not in ("device", "seed", "stop_threshold"):
                setattr(model_cfg, k, v)
        seed = int(settings.get("seed", 0))
        if policy is not None:  # a shared policy brings its own config
            self.policy, model_cfg = policy, policy.cfg
        else:
            policy_cls = get_policy("rdp")
            device = resolve_device(settings.get("device"))
            if cfg.ckpt_path:
                self.policy = policy_cls.from_pretrained(cfg.ckpt_path, cfg=model_cfg,
                                                         device=device, seed=seed)
            else:
                self.policy = policy_cls.build(model_cfg, device=device, seed=seed)
        self.model_cfg = model_cfg
        self.len_traj_act = model_cfg.len_traj_act
        self.hidden = model_cfg.state_encoder.hidden_size
        self.stop_threshold = float(settings.get("stop_threshold", 0.85))
        #: None, or n → an act call's draws for n envs (`RDPNet.act_draws`)
        self.draw_fn: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None
        self._states: Optional[torch.Tensor] = None
        self._masks: Optional[torch.Tensor] = None
        self._prev_actions: Optional[np.ndarray] = None
        self._caches: Optional[List[List[np.ndarray]]] = None

    def _ensure(self, n: int) -> None:
        if self._states is None or self._states.shape[0] != n:
            dev = self.policy.device
            self._states = torch.zeros((n, 1, self.hidden), device=dev)
            self._masks = torch.zeros((n,), device=dev)
            self._prev_actions = np.zeros((n, self.len_traj_act, 3), np.float32)
            self._caches = [[] for _ in range(n)]

    def reset(self, reset_index: Optional[List[int]] = None) -> None:
        if self._states is None:
            return
        ids = list(range(self._states.shape[0])) if reset_index is None else list(reset_index)
        idx = torch.as_tensor(ids, dtype=torch.long, device=self._states.device)
        self._states[idx] = 0
        self._masks[idx] = 0
        for i in ids:
            self._prev_actions[i] = 0
            self._caches[i] = []

    def _build_obs(self, obs: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        rows = []
        for o in obs:
            instr = np.asarray(o["instruction"], np.int32)
            padded = np.ones((self.instr_pad_len,), np.int32)  # roberta pad id = 1
            padded[: min(len(instr), self.instr_pad_len)] = instr[: self.instr_pad_len]
            rgb = np.asarray(o["rgb"], np.float32)
            if rgb.shape[:2] != (RGB_HW, RGB_HW):
                rgb = resize_bilinear(rgb, (RGB_HW, RGB_HW))
            depth = np.asarray(o["depth"], np.float32)
            if depth.ndim == 3:
                depth = depth[..., 0]
            if depth.shape != (DEPTH_HW, DEPTH_HW):
                depth = resize_nearest(depth, (DEPTH_HW, DEPTH_HW))
            imu = np.asarray(o.get("imu", np.zeros(3)), np.float32)
            rows.append({"instruction": padded, "rgb": rgb, "depth": depth[..., None],
                         "imu": imu})
        return batch_obs(rows)

    def step_coroutine(self, obs: List[Dict[str, Any]]):
        """Generator form of `step` for pipelined evaluation: the RNN update
        and, when a cache is empty, the denoise are queued on the device
        before the yield (whether to act depends only on the host caches),
        so their fetches after the resume overlap other cohorts' work."""
        n = len(obs)
        self._ensure(n)
        dev = self.policy.device
        base = {
            "observations": tree_device_put(self._build_obs(obs), dev),
            "rnn_states": self._states,
            "prev_actions": torch.as_tensor(self._prev_actions).to(dev),
            "masks": self._masks,
        }
        _, states = self.policy.forward(dict(base, mode="update_rnn"))
        need_act = any(len(c) == 0 for c in self._caches)
        act_out = None
        if need_act:
            act = dict(base, mode="act")
            if self.draw_fn is not None:
                act["draws"] = self.draw_fn(n)
            act_out = self.policy.forward(act)
        yield  # device busy: update_rnn (+ act) in flight
        self._states = states
        self._masks = torch.ones_like(self._masks)

        stop_flags = np.zeros((n,), bool)
        if need_act:
            traj, _, _, stop_progress, _ = act_out
            waypoints = self.policy.unnormalize_actions(traj, cumsum=False)
            stop_np = stop_progress.detach().cpu().numpy().reshape(n)
            for i in range(n):
                if len(self._caches[i]) == 0:
                    self._caches[i] = list(waypoints[i][: self.len_traj_act])
                    stop_flags[i] = stop_np[i] > self.stop_threshold

        out = []
        for i in range(n):
            wp = self._caches[i].pop(0)
            self._prev_actions[i] = np.roll(self._prev_actions[i], 1, axis=0)
            self._prev_actions[i][0] = wp
            if stop_flags[i]:
                out.append({"action": [0], "ideal_flag": True, "waypoint": wp.tolist(),
                            "stop": True})
            else:
                out.append({"action": self._waypoint_to_discrete(wp), "ideal_flag": True,
                            "waypoint": wp.tolist(), "stop": False})
        return out

    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        gen = self.step_coroutine(obs)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value

    @staticmethod
    def _waypoint_to_discrete(wp: np.ndarray) -> List[int]:
        """Continuous (dx, dy, dyaw) → discrete VLN action (reference
        parse_action 'discrete' eval mode, map_action_to_2d semantics)."""
        dx, dy, dyaw = float(wp[0]), float(wp[1]), float(wp[2])
        if abs(dyaw) > 0.13:  # ≥ half of 15°
            return [2] if dyaw > 0 else [3]
        if dx > 0.05:
            return [1]
        return [0]
