"""NavDP: the goal-conditioned diffusion policy for visual navigation.

Port of internnav_tpu/model/basemodel/navdp.py (`NavDPNet`, `NavDPPolicy`;
reference internnav/model/basemodel/navdp/navdp_policy.py):

- RGB-D memory tokens from two ViT-S towers over memory_size frames
  (`RGBDBackbone`); goal encoders: the point (a Linear on xyz), the image
  (a 6-channel ViT-S) and the pixel (a 7-channel ViT-S);
- the denoiser: a temporal_depth-layer pre-norm transformer decoder over
  cond = [time, goal, goal, goal, rgbd(memory·16)] plus a learned cond
  position embedding; the target mask keeps only strictly future
  waypoints (the reference's bool mask read as torch reads it), so the
  last waypoint's row attends to nothing and its probabilities are zero;
  DDPM over 10 timesteps (squaredcos_cap_v2, epsilon, x0 clipped);
- the critic: the same decoder with the 4 goal slots masked out of the
  memory, mean-pooled, then `critic_head`; it ranks the sampled
  trajectories.

Every random draw is an argument: the training forward takes (t, ε) for
its no-goal and multi-goal branches (`train_draws`), inference its x_init
and the step noises (`infer_draws`); the policy draws them from its
`torch.Generator` when the caller hands in none. Arithmetic is fp32; the
towers run their convolutions with TF32 off.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from internnav_tpu_torch.configs.model import ModelCfg
from internnav_tpu_torch.model.base import Policy, resolve_device
from internnav_tpu_torch.model.encoder.navdp_backbone import (
    FormerDecoder,
    ImageGoalBackbone,
    PixelGoalBackbone,
    RGBDBackbone,
)
from internnav_tpu_torch.model.encoder.transformer import SinusoidalPosEmb
from internnav_tpu_torch.ops.schedulers import DDPMScheduler

#: the inference modes and the observation each takes its goal from
GOAL_KEYS = {"pointgoal": "goal_point", "imagegoal": "goal_image",
             "pixelgoal": "goal_pixel", "nogoal": None}


def navdp_tgt_mask(P: int, device=None) -> torch.Tensor:
    """(P, P) bool, True = keep: waypoint i attends to waypoints j > i only
    (JAX `_ref_navdp_tgt_mask`)."""
    idx = torch.arange(P, device=device)
    return idx[None, :] > idx[:, None]


class NavDPNet(nn.Module):
    def __init__(self, cfg: ModelCfg, image_size: int = 224):
        super().__init__()
        self.cfg = cfg
        self.memory_size = getattr(cfg, "memory_size", 8)
        self.predict_size = getattr(cfg, "predict_size", 24)
        self.token_dim = getattr(cfg, "token_dim", 384)
        self.temporal_depth = getattr(cfg, "temporal_depth", 8)
        self.heads = getattr(cfg, "heads", 8)
        D, M, P = self.token_dim, self.memory_size, self.predict_size
        self.rgbd_encoder = RGBDBackbone(embed_size=D, memory_size=M, token_dim=384,
                                         image_hw=image_size)
        self.pixel_encoder = PixelGoalBackbone(embed_size=D, image_hw=image_size)
        self.image_encoder = ImageGoalBackbone(embed_size=D, image_hw=image_size)
        self.point_encoder = nn.Linear(3, D)
        self.decoder = FormerDecoder(D, self.heads, self.temporal_depth, norm_first=True)
        self.input_embed = nn.Linear(3, D)
        self.cond_pos_embed = nn.Embedding(M * 16 + 4, D)
        self.out_pos_embed = nn.Embedding(P, D)
        self.time_emb = SinusoidalPosEmb(D)
        self.final_ln = nn.LayerNorm(D, eps=1e-6)  # flax's default, as in JAX
        self.action_head = nn.Linear(D, 3)
        self.critic_head = nn.Linear(D, 1)
        self.pixel_aux_head = nn.Linear(D, 3)
        self.image_aux_head = nn.Linear(D, 3)
        self.scheduler = DDPMScheduler(num_train_timesteps=10,
                                       beta_schedule="squaredcos_cap_v2")
        self.register_buffer("tgt_mask", navdp_tgt_mask(P), persistent=False)
        tc = M * 16 + 4
        critic_mask = torch.ones((P, tc), dtype=torch.bool)
        critic_mask[:, :4] = False  # the time and goal slots
        self.register_buffer("critic_mask", critic_mask, persistent=False)

    # -------------------------------------------------------------- draws
    def train_draws(self, B: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """A training step's draws: the no-goal and multi-goal branches'
        timesteps (B,) and ε (B, P, 3)."""
        T = self.scheduler.num_train_timesteps
        shape = (B, self.predict_size, 3)
        out = {}
        for branch in ("ng", "mg"):
            out[f"{branch}_t"] = torch.randint(0, T, (B,), generator=generator, device=device)
            out[f"{branch}_noise"] = torch.randn(shape, generator=generator, device=device)
        return out

    def infer_draws(self, rows: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """An inference call's draws over rows = B · sample_num: x_init
        first, then the per-step ancestral noises (steps, rows, P, 3)."""
        shape = (rows, self.predict_size, 3)
        steps = len(self.scheduler.timesteps())
        x_init = torch.randn(shape, generator=generator, device=device)
        return {"x_init": x_init,
                "noises": torch.randn((steps,) + shape, generator=generator, device=device)}

    # ------------------------------------------------------------ helpers
    def _cond(self, time_embeds, goals, rgbd_embed):
        """[time(1), goals(3), rgbd(memory·16)] + the learned cond PE."""
        cond = torch.cat([time_embeds, *goals, rgbd_embed], dim=1)
        return cond + self.cond_pos_embed.weight[: cond.shape[1]][None]

    def _embed_actions(self, actions):
        x = self.input_embed(actions)
        return x + self.out_pos_embed.weight[: x.shape[1]][None]

    def _denoise(self, noisy, t, goals, rgbd_embed):
        """ε of noisy (B, P, 3) at timesteps t (B,) under three goal slots."""
        cond = self._cond(self.time_emb(t)[:, None], goals, rgbd_embed)
        out = self.decoder(self._embed_actions(noisy), cond, tgt_mask=self.tgt_mask)
        return self.action_head(self.final_ln(out))

    def predict_noise(self, noisy_actions, t, goal_embed, rgbd_embed):
        """noisy_actions (B, P, 3); t a scalar or (B,) → ε (B, P, 3)."""
        B = noisy_actions.shape[0]
        t = torch.as_tensor(t, device=noisy_actions.device).reshape(-1).expand(B)
        return self._denoise(noisy_actions, t, (goal_embed,) * 3, rgbd_embed)

    def predict_critic(self, trajectories, rgbd_embed):
        """trajectories (B, P, 3) in action units → (B,) critic values; the
        time and goal slots are masked out of the memory."""
        B = trajectories.shape[0]
        zero = rgbd_embed.new_zeros((B, 1, self.token_dim))
        cond = self._cond(zero, (zero,) * 3, rgbd_embed)
        out = self.decoder(self._embed_actions(trajectories), cond,
                           memory_mask=self.critic_mask[:, : cond.shape[1]])
        return self.critic_head(self.final_ln(out).mean(dim=1))[:, 0]

    # ----------------------------------------------------------- training
    def forward(self, goal_point, goal_image, goal_pixel, input_images, input_depths,
                output_actions, augment_actions, draws: Dict[str, torch.Tensor]):
        """The training forward (reference navdp_policy.py:187-273) with the
        step's draws (`train_draws`). Returns (eps_ng, eps_mg, critic_label,
        critic_augment, ng_noise, mg_noise, image_aux, pixel_aux)."""
        B = output_actions.shape[0]
        rgbd_embed = self.rgbd_encoder(input_images, input_depths)
        point_embed = self.point_encoder(goal_point)[:, None]
        nogoal = torch.zeros_like(point_embed)
        image_embed = self.image_encoder(goal_image)[:, None]
        pixel_embed = self.pixel_encoder(goal_pixel)[:, None]
        image_aux = self.image_aux_head(image_embed[:, 0])
        pixel_aux = self.pixel_aux_head(pixel_embed[:, 0])

        sched = self.scheduler
        ng_noise, mg_noise = draws["ng_noise"].float(), draws["mg_noise"].float()
        ng_noisy = sched.add_noise(output_actions, ng_noise, draws["ng_t"])
        mg_noisy = sched.add_noise(output_actions, mg_noise, draws["mg_t"])

        # each sample's goal pattern: the base-3 digits of i % 27
        # (navdp_policy.py:219-235)
        idx = torch.arange(B, device=output_actions.device) % 27
        goals = torch.stack([point_embed, image_embed, pixel_embed])  # (3, B, 1, D)
        rows = torch.arange(B, device=idx.device)
        pick = [goals[(idx // 3 ** k) % 3, rows] for k in range(3)]

        eps_ng = self._denoise(ng_noisy, draws["ng_t"], (nogoal,) * 3, rgbd_embed)
        eps_mg = self._denoise(mg_noisy, draws["mg_t"], pick, rgbd_embed)
        critic_label = self.predict_critic(output_actions.detach(), rgbd_embed)
        critic_augment = self.predict_critic(augment_actions.detach(), rgbd_embed)
        return (eps_ng, eps_mg, critic_label, critic_augment, ng_noise, mg_noise,
                image_aux, pixel_aux)

    # ---------------------------------------------------------- inference
    def denoise_and_rank(self, goal_embed, rgbd_embed, draws, sample_num: int, topk: int = 8):
        """sample_num trajectories a row from draws' x_init and step noises,
        ranked by the critic → (worst topk, best topk), each (B, k, P, 3)
        integrated waypoints (cumsum of the actions / 4)."""
        B = rgbd_embed.shape[0]
        goal_rep = goal_embed.repeat_interleave(sample_num, dim=0)
        rgbd_rep = rgbd_embed.repeat_interleave(sample_num, dim=0)
        naction = self.scheduler.denoise(
            lambda x, t: self.predict_noise(x, t, goal_rep, rgbd_rep),
            draws["x_init"], draws["noises"])
        critic = self.predict_critic(naction, rgbd_rep).reshape(B, sample_num)
        trajs = torch.cumsum(naction / 4.0, dim=1).reshape(B, sample_num, self.predict_size, 3)
        k = min(topk, sample_num)
        best = torch.topk(critic, k, dim=1).indices
        worst = torch.topk(-critic, k, dim=1).indices
        rows = torch.arange(B, device=trajs.device)[:, None]
        return trajs[rows, worst], trajs[rows, best]

    def goal_embed(self, mode: str, obs: Dict[str, torch.Tensor], rgbd_embed):
        """The (B, 1, D) goal token of an inference mode."""
        if mode == "nogoal":
            return torch.zeros_like(rgbd_embed[:, :1])
        encoder = {"pointgoal": self.point_encoder, "imagegoal": self.image_encoder,
                   "pixelgoal": self.pixel_encoder}[mode]
        return encoder(obs[GOAL_KEYS[mode]])[:, None]

    def predict(self, mode: str, obs: Dict[str, torch.Tensor], draws, sample_num: int = 32):
        """predict_{pointgoal,nogoal,imagegoal,pixelgoal} of the JAX module."""
        rgbd_embed = self.rgbd_encoder(obs["input_images"], obs["input_depths"])
        return self.denoise_and_rank(self.goal_embed(mode, obs, rgbd_embed), rgbd_embed,
                                     draws, sample_num)


class NavDPPolicy(Policy):
    name = "NavDP_Policy"
    REFERENCE_CONVERTER_NAME = "convert_navdp_policy"

    def __init__(self, net: NavDPNet, cfg: ModelCfg, seed: int = 0):
        super().__init__(net, cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def build(cls, cfg: ModelCfg, device=None, seed: int = 0,
              image_size: Optional[int] = None) -> "NavDPPolicy":
        """A random net (torch's initializers, drawn from `seed`) on
        `device`: the GPU when None; "cpu" only when asked for. `forward`'s
        draws come from a generator seeded with `seed` too. image_size
        (the config's `image_size`, else 224) sizes the towers' position
        embeddings."""
        device = resolve_device(device)
        if image_size is None:
            image_size = int(getattr(cfg, "image_size", 224))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = NavDPNet(cfg, image_size=image_size)
        return cls(net.to(device), cfg, seed)

    @classmethod
    def from_pretrained(cls, path: str, cfg: Optional[ModelCfg] = None, device=None,
                        seed: int = 0, image_size: Optional[int] = None) -> "NavDPPolicy":
        """A native directory or a reference-format checkpoint on `device`."""
        cfg = cls.load_config(path, default=cfg)
        pol = cls.build(cfg, device, seed, image_size=image_size)
        pol.net.load_state_dict(cls.load_params_file(path, pol.net))
        return pol

    def _tensors(self, obs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """numpy or tensor observations as fp32 tensors on the policy's
        device."""
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   dtype=torch.float32, device=self.device)
                for k, v in obs.items() if v is not None}

    def forward(self, batch: Dict[str, Any]):
        """batch["mode"]: "train" → the training forward's 8 outputs (with
        gradients); "pointgoal" / "nogoal" / "imagegoal" / "pixelgoal" →
        (negative, positive) trajectories (B, k, P, 3), best first.
        batch["draws"] holds the mode's draws (`NavDPNet.train_draws` /
        `infer_draws`), else they come from the policy's generator."""
        mode = batch.get("mode", "train")
        obs = self._tensors(batch["observations"])
        draws = batch.get("draws")
        net: NavDPNet = self.net
        if mode == "train":
            if draws is None:
                draws = net.train_draws(obs["output_actions"].shape[0], self.generator,
                                        self.device)
            return net(obs["goal_point"], obs["goal_image"], obs["goal_pixel"],
                       obs["input_images"], obs["input_depths"], obs["output_actions"],
                       obs["augment_actions"], draws)
        if mode not in GOAL_KEYS:
            raise KeyError(f"unknown NavDP mode {mode!r}")
        sample_num = int(batch.get("sample_num", 32))
        if draws is None:
            draws = net.infer_draws(obs["input_images"].shape[0] * sample_num, self.generator,
                                    self.device)
        with torch.no_grad():
            return net.predict(mode, obs, draws, sample_num)
