"""NavDP agent ("navdp"): goal-conditioned visual-navigation inference.

Port of internnav_tpu/agent/navdp_agent.py (the reference evaluates NavDP
inside the InternUtopia VN benchmark; navdp_policy.py:302
predict_pointgoal_batch_action_vel): a memory_size frame stack (padded
with its first frame), a replan every `replan_every` steps (4) over
`sample_num` (16) denoised trajectories ranked by the critic, and the
best trajectory's deltas executed one a step as waypoints and velocities.
model_settings: image_size (224), replan_every, sample_num, goal_mode
("pointgoal" | "nogoal" | "imagegoal"), seed (0), device; the others set
fields of the navdp config.

Frames are resized without cv2 (`recurrent_agent.resize_bilinear` and
`resize_nearest`, cv2's rules), kept on the host, and the stack goes to
the policy's device once a replan. The policy is built on the GPU unless
model_settings["device"] asks for the CPU (no fallback). A replan's draws
(x_init and the step noises) come from `draw(rows)`: the agent's
`torch.Generator`, seeded with model_settings["seed"]; the parity tests
replace it with JAX's keys.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from internnav_tpu_torch.agent.base import Agent
from internnav_tpu_torch.agent.recurrent_agent import resize_bilinear, resize_nearest
from internnav_tpu_torch.configs.agent import AgentCfg
from internnav_tpu_torch.model import get_config, get_policy
from internnav_tpu_torch.model.base import resolve_device

#: model_settings that steer the agent, not the policy's config
AGENT_SETTINGS = ("image_size", "replan_every", "sample_num", "goal_mode", "seed", "device")


@Agent.register("navdp")
class NavDPAgent(Agent):
    def __init__(self, cfg: AgentCfg, policy=None):
        super().__init__(cfg)
        s = dict(cfg.model_settings or {})
        self.image_size = int(s.get("image_size", 224))
        seed = int(s.get("seed", 0))
        if policy is None:
            model_cfg = get_config("navdp")
            for k, v in s.items():
                if k not in AGENT_SETTINGS:
                    setattr(model_cfg, k, v)
            cls = get_policy("navdp")
            device = resolve_device(s.get("device"))
            if cfg.ckpt_path:
                policy = cls.from_pretrained(cfg.ckpt_path, cfg=model_cfg, device=device,
                                             image_size=self.image_size)
            else:
                policy = cls.build(model_cfg, device=device, image_size=self.image_size)
        self.policy = policy
        self.memory_size = getattr(self.policy.cfg, "memory_size", 8)
        self.replan_every = int(s.get("replan_every", 4))
        self.sample_num = int(s.get("sample_num", 16))
        self.goal_mode = s.get("goal_mode", "pointgoal")
        self.generator = torch.Generator(device=self.policy.device).manual_seed(seed)
        self.reset()

    def reset(self, reset_index: Optional[List[int]] = None) -> None:
        self.rgb_memory: List[np.ndarray] = []
        self.depth_memory: List[np.ndarray] = []
        self.plan: List[np.ndarray] = []

    def draw(self, rows: int) -> Dict[str, torch.Tensor]:
        """A replan's draws over `rows` trajectories."""
        return self.policy.net.infer_draws(rows, self.generator, self.policy.device)

    def _push_memory(self, obs: Dict[str, Any]) -> None:
        hw = (self.image_size, self.image_size)
        rgb = np.asarray(obs["rgb"], np.float32)
        if rgb.shape[:2] != hw:
            rgb = resize_bilinear(rgb, hw)
        depth = np.asarray(obs.get("depth", np.zeros(rgb.shape[:2])), np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        if depth.shape != hw:
            depth = resize_nearest(depth, hw)
        self.rgb_memory = (self.rgb_memory + [rgb / 255.0])[-self.memory_size:]
        self.depth_memory = (self.depth_memory + [depth[..., None]])[-self.memory_size:]

    def _memory_stack(self):
        pads = self.memory_size - len(self.rgb_memory)
        rgb = [self.rgb_memory[0]] * pads + self.rgb_memory
        depth = [self.depth_memory[0]] * pads + self.depth_memory
        return np.stack(rgb)[None], np.stack(depth)[None]

    def _replan(self, o: Dict[str, Any]) -> np.ndarray:
        """The best of sample_num trajectories (P, 3), integrated waypoints."""
        rgb, depth = self._memory_stack()
        s = self.image_size
        batch = {
            "mode": self.goal_mode,
            "observations": {
                "input_images": rgb, "input_depths": depth,
                "goal_point": np.asarray(o.get("pointgoal", [1.0, 0.0, 0.0]),
                                         np.float32)[None],
                "goal_image": np.zeros((1, s, s, 6), np.float32),
                "goal_pixel": np.zeros((1, s, s, 7), np.float32),
            },
            "draws": self.draw(self.sample_num),
            "sample_num": self.sample_num,
        }
        _, positive = self.policy.forward(batch)
        return positive[0, 0].cpu().numpy()

    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        assert len(obs) == 1, "VN agent is single-env"
        o = obs[0]
        self._push_memory(o)
        if not self.plan:
            best = self._replan(o)
            deltas = np.diff(np.concatenate([np.zeros((1, 3)), best], 0), axis=0)
            self.plan = list(deltas[: self.replan_every])
        wp = self.plan.pop(0)
        return [{"action": [1], "ideal_flag": True, "waypoint": wp.tolist(),
                 "velocity": [float(wp[0]) * 4.0, float(wp[2]) * 4.0]}]
