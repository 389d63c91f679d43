"""RDP: the continuous-action diffusion-policy VLN model.

Port of internnav_tpu/model/basemodel/rdp.py (reference
internnav/model/basemodel/rdp/rdp_policy.py: RDPNet.__init__:116-297,
denoise_actions:318-362, update_rnn_states:683, forward:985) at the
default rdp_cfg dims: the RoBERTa-style text encoder at the state width
(or LongCLIP with text_encoder.model_name "clip-long"), CLIP RGB + DD-PPO
depth fused to 5 tokens, GRU 512, a 3-layer / 512 diffusion transformer
over 8 waypoints of (dx, dy, dyaw), a 20-step DDPM (squaredcos betas, x0
clamped to ±1) with classifier-free guidance (scale 1.5, the image and
text condition tokens masked), and the progress and stop-progress heads
on [state; fused text token].

Modes of `RDPNet.forward`: "update_rnn" → (state, rnn_states); "train"
→ (ε prediction, ε, rnn_states, progress, stop_progress, distance) on the
noised normalized ground-truth actions; "act" → (trajectory, rnn_states,
progress, stop_progress, distance), the normalized trajectory from the
CFG denoise loop: conditional rows then null rows in one batch, the
guided ε at t ≠ 0 and the conditional ε alone at t = 0.

Every random draw is explicit. Training takes (t, ε, CFG mask rows) and
acting (x_init, the per-step noises) from `draws` when the caller passes
them (the parity tests pass JAX's), else from the policy's own
`torch.Generator`, seeded at build.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from internnav_tpu_torch.configs.model import ModelCfg
from internnav_tpu_torch.model.base import Policy, resolve_device
from internnav_tpu_torch.model.encoder.bert import LanguageEncoder, VisionLanguageEncoder
from internnav_tpu_torch.model.encoder.clip_vit import CLIPImageEncoder
from internnav_tpu_torch.model.encoder.diffusion_transformer import (
    DistanceNetwork,
    TransformerForDiffusion,
)
from internnav_tpu_torch.model.encoder.rnn_state import RNNStateEncoder
from internnav_tpu_torch.ops.schedulers import DDPMScheduler

#: the frame sizes of the reference's observation space
RGB_HW = 224
DEPTH_HW = 256


def text_encoder_of(cfg: ModelCfg, width: int) -> nn.Module:
    """LongCLIP for text_encoder.model_name "clip-long" (the shipped
    rdp_cfg's text path, configs/model/rdp.py:30), else the RoBERTa-style
    encoder, 8 heads, both at `width`."""
    tc = cfg.text_encoder
    if getattr(tc, "model_name", "") == "clip-long":
        from internnav_tpu_torch.model.encoder.longclip import LongCLIPTextEncoder

        return LongCLIPTextEncoder(vocab_size=tc.vocab_size, width=width,
                                   layers=tc.num_l_layers, heads=getattr(tc, "num_heads", 8),
                                   context_length=getattr(tc, "max_length", 248))
    return LanguageEncoder(vocab_size=tc.vocab_size, hidden_size=width,
                           num_layers=tc.num_l_layers, num_heads=8, intermediate_size=4 * width)


class RDPNet(nn.Module):
    def __init__(self, cfg: ModelCfg, depth_hw: int = DEPTH_HW, rgb_hw: int = RGB_HW):
        super().__init__()
        c = self.cfg = cfg
        dp = c.diffusion_policy
        H = c.state_encoder.hidden_size
        na = self.num_actions = 3 if c.learn_angle else 2
        self.instruction_encoder = text_encoder_of(c, H)
        self.image_encoder = CLIPImageEncoder(
            projection_dim=H, img_mod=c.image_encoder.rgb.img_mod,
            vit_width=getattr(c, "vit_width", 768), vit_layers=getattr(c, "vit_layers", 12),
            vit_heads=getattr(c, "vit_heads", 12), image_hw=rgb_hw, depth_hw=depth_hw)
        self.prev_action_embedding = nn.Linear(3, 64)
        self.prev_action_embedding_dp = nn.Linear(3, H)
        self.imu_linear = nn.Linear(3, 64)
        self.imu_linear_dp = nn.Linear(3, H)
        self.vis_tokens = 5 if c.image_encoder.rgb.img_mod == "multi_patches_avg_pooling" else 1
        self.state_encoder = RNNStateEncoder(self.vis_tokens * H + 64 + 64, H,
                                             c.state_encoder.rnn_type)
        xm = c.cross_modal_encoder
        self.img_txt_cross_encoder = VisionLanguageEncoder(
            H, xm.num_attention_heads if xm else 8, xm.num_x_layers if xm else 2)
        self.txt_img_cross_encoder = VisionLanguageEncoder(H, 8, 2)
        self.n_obs_steps = self.vis_tokens + 1 + 1 + 1 + 1 + c.len_traj_act
        self.action_dp_pred_net = TransformerForDiffusion(
            input_dim=na, output_dim=na, horizon=dp.len_traj_pred, n_obs_steps=self.n_obs_steps,
            cond_dim=H, n_emb=dp.n_emb, n_layer=dp.n_layer, n_cond_layers=1)
        self.action_type_embeds = nn.Embedding(10, dp.n_emb)
        self.progress_monitor = DistanceNetwork(2 * H, normalize=True)
        self.stop_progress_predictor = DistanceNetwork(2 * H, normalize=True)
        # the optional distance-to-goal head on the GRU state (reference
        # rdp_policy.py:267-272, 643-647; off in the shipped rdp_cfg)
        dist = c.distance_predictor
        self.distance_pred_net = (DistanceNetwork(H, normalize=dist.normalize)
                                  if dist is not None and dist.use else None)
        self.scheduler = DDPMScheduler(num_train_timesteps=dp.num_train_timesteps,
                                       beta_schedule="squaredcos_cap_v2")

    # ----------------------------------------------------------- encoders
    def _encode_step(self, obs, rnn_states, prev_actions, masks):
        """(state, rnn_states out, the 5 RGB-D tokens, masked prev actions, imu)."""
        prev = prev_actions.float() * masks.float()[:, None, None]  # (B, La, 3)
        rgbd = self.image_encoder(obs["rgb"], obs["depth"])  # (B, 5, H)
        imu = obs.get("imu")
        if imu is None:
            imu = rgbd.new_zeros((rgbd.shape[0], 3))
        latest_prev = self.prev_action_embedding(prev)[:, 0]
        concat = torch.cat([rgbd.reshape(rgbd.shape[0], -1), latest_prev,
                            self.imu_linear(imu.float())], dim=1)
        state, rnn_out = self.state_encoder(concat, rnn_states, masks)
        return state, rnn_out, rgbd, prev, imu.float()

    def _conditioning(self, obs, rnn_states, prev_actions, masks):
        state, rnn_out, rgbd, prev, imu = self._encode_step(obs, rnn_states, prev_actions, masks)
        txt, txt_valid, _ = self.instruction_encoder(obs["instruction"])
        state_tok = state[:, None]
        vis_state = torch.cat([rgbd, state_tok], dim=1)  # (B, 6, H)
        img_txt, _ = self.img_txt_cross_encoder(vis_state, txt, None, txt_valid)
        txt_img, _ = self.txt_img_cross_encoder(txt, vis_state, txt_valid, None)
        prev_dp = self.prev_action_embedding_dp(prev)
        cond = torch.cat([img_txt, txt_img[:, :1], state_tok, self.imu_linear_dp(imu)[:, None],
                          prev_dp], dim=1)
        type_ids = [0] * img_txt.shape[1] + [1, 2, 4] + [5] * prev_dp.shape[1]
        type_embeds = self.action_type_embeds(torch.tensor(type_ids, device=cond.device))
        type_embeds = type_embeds[None].expand(cond.shape[0], -1, -1)
        heads_in = torch.cat([state, txt_img[:, 0]], dim=1)
        progress = self.progress_monitor(heads_in)
        stop_progress = self.stop_progress_predictor(heads_in)
        distance = self.distance_pred_net(state) if self.distance_pred_net is not None else None
        return cond, type_embeds, rnn_out, progress, stop_progress, distance, img_txt.shape[1]

    def guided_token_mask(self, n_img: int, device) -> torch.Tensor:
        """(1 + n_obs_steps,) float: 1 on the tokens classifier-free
        guidance masks (the image tokens and the text token; the time token
        is 0)."""
        m = torch.zeros(1 + self.n_obs_steps, device=device)
        m[1: 1 + n_img + 1] = 1.0
        return m

    # ------------------------------------------------------------- draws
    def train_draws(self, B: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """A training step's draws: timesteps (B,), ε and the CFG mask rows
        (B,) bool (each row masked with probability cls_mask_ratio)."""
        dp = self.cfg.diffusion_policy
        shape = (B, dp.len_traj_pred, self.num_actions)
        return {"t": torch.randint(0, self.scheduler.num_train_timesteps, (B,),
                                   generator=generator, device=device),
                "noise": torch.randn(shape, generator=generator, device=device),
                "mask_rows": torch.rand((B,), generator=generator, device=device)
                < dp.cls_mask_ratio}

    def act_draws(self, B: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """An act call's draws: x_init (B, P, na) first, then the per-step
        ancestral noises (steps, B, P, na)."""
        dp = self.cfg.diffusion_policy
        shape = (B, dp.len_traj_pred, self.num_actions)
        x_init = torch.randn(shape, generator=generator, device=device)
        steps = len(self.scheduler.timesteps())
        return {"x_init": x_init,
                "noises": torch.randn((steps,) + shape, generator=generator, device=device)}

    # ------------------------------------------------------------ training
    def train_forward(self, obs, rnn_states, prev_actions, masks, draws):
        """ε predicted on the noised ground truth (obs["actions"], normalized
        (B, len_traj_pred, na)) and the aux heads."""
        cond, type_embeds, rnn_out, progress, stop_progress, distance, n_img = \
            self._conditioning(obs, rnn_states, prev_actions, masks)
        naction = obs["actions"].float()
        t, noise = draws["t"], draws["noise"].float()
        noisy = self.scheduler.add_noise(naction, noise, t)
        cond_mask = draws["mask_rows"].float()[:, None] * self.guided_token_mask(n_img, cond.device)
        eps = self.action_dp_pred_net(noisy, t, cond, type_embeds, cond_mask)
        return eps, noise, rnn_out, progress, stop_progress, distance

    # ----------------------------------------------------------- inference
    def denoise(self, obs, rnn_states, prev_actions, masks, draws,
                guidance_scale: float = 1.5):
        cond, type_embeds, rnn_out, progress, stop_progress, distance, n_img = \
            self._conditioning(obs, rnn_states, prev_actions, masks)
        B = cond.shape[0]
        if self.cfg.diffusion_policy.use_cls_free_guidance:
            null = self.guided_token_mask(n_img, cond.device)[None].expand(B, -1)
            cond_mask = torch.cat([torch.zeros_like(null), null], dim=0)
            cond2 = torch.cat([cond, cond], dim=0)
            types2 = torch.cat([type_embeds, type_embeds], dim=0)

            def predict_eps(x, t):
                eps = self.action_dp_pred_net(torch.cat([x, x], dim=0), t.expand(2 * B), cond2,
                                              types2, cond_mask)
                eps_c, eps_u = eps[:B], eps[B:]
                guided = eps_u + guidance_scale * (eps_c - eps_u)
                # guidance only for t != 0 (rdp_policy.py:344-350): the last
                # step takes the conditional prediction alone
                return torch.where(t != 0, guided, eps_c)
        else:
            def predict_eps(x, t):
                return self.action_dp_pred_net(x, t.expand(B), cond, type_embeds, None)

        traj = self.scheduler.denoise(predict_eps, draws["x_init"].float(),
                                      draws["noises"].float())
        return traj, rnn_out, progress, stop_progress, distance

    def forward(self, obs, rnn_states, prev_actions, masks, mode: str = "update_rnn",
                draws: Optional[Dict[str, torch.Tensor]] = None):
        if mode == "update_rnn":
            state, rnn_out, *_ = self._encode_step(obs, rnn_states, prev_actions, masks)
            return state, rnn_out
        if mode == "train":
            return self.train_forward(obs, rnn_states, prev_actions, masks, draws)
        if mode == "act":
            return self.denoise(obs, rnn_states, prev_actions, masks, draws,
                                self.cfg.diffusion_policy.cls_free_guidance_scale)
        raise ValueError(mode)


class RDPPolicy(Policy):
    name = "RDP_Policy"
    REFERENCE_CONVERTER_NAME = "convert_rdp_policy"

    ACTION_STATS = {"min": np.asarray([-0.25, -0.25, -0.27]),
                    "max": np.asarray([0.25, 0.25, 0.27])}

    def __init__(self, net: nn.Module, cfg: ModelCfg, seed: int = 0):
        super().__init__(net, cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def build(cls, cfg: ModelCfg, device=None, seed: int = 0, depth_hw: int = DEPTH_HW,
              rgb_hw: int = RGB_HW) -> "RDPPolicy":
        """A random net (torch's initializers, drawn from `seed`) on
        `device`: the GPU when None; "cpu" only when asked for. The draws
        of `forward` come from a generator seeded with `seed` too."""
        device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = RDPNet(cfg, depth_hw=depth_hw, rgb_hw=rgb_hw)
        return cls(net.to(device), cfg, seed)

    @classmethod
    def from_pretrained(cls, path: str, cfg: Optional[ModelCfg] = None, device=None,
                        seed: int = 0, depth_hw: int = DEPTH_HW,
                        rgb_hw: int = RGB_HW) -> "RDPPolicy":
        """A native directory or a reference-format checkpoint on `device`."""
        cfg = cls.load_config(path, default=cfg)
        pol = cls.build(cfg, device, seed, depth_hw=depth_hw, rgb_hw=rgb_hw)
        pol.net.load_state_dict(cls.load_params_file(path, pol.net))
        return pol

    def num_recurrent_layers(self) -> int:
        return 1

    def forward(self, batch: Dict[str, Any]):
        """Modes (reference rdp_agent.py:267-337): "update_rnn" each step,
        "act" when a waypoint cache is empty, "train" in the trainer.
        batch["draws"] holds the mode's draws (`RDPNet.train_draws` /
        `act_draws`), else they come from the policy's own generator.
        Gradients only in mode "train"."""
        mode = batch.get("mode", "update_rnn")
        obs = batch["observations"]
        draws = batch.get("draws")
        if draws is None and mode in ("train", "act"):
            B = obs["rgb"].shape[0]
            draws = (self.net.train_draws if mode == "train" else self.net.act_draws)(
                B, self.generator, self.device)
        with torch.set_grad_enabled(mode == "train"):
            return self.net(obs, batch["rnn_states"], batch["prev_actions"], batch["masks"],
                            mode=mode, draws=draws)

    def unnormalize_actions(self, traj, cumsum: bool = True) -> np.ndarray:
        """[-1, 1] deltas → metric waypoints (reference get_action
        semantics), on the host."""
        stats = self.ACTION_STATS
        traj = traj.detach().cpu().numpy() if torch.is_tensor(traj) else np.asarray(traj)
        deltas = (traj + 1.0) / 2.0 * (stats["max"] - stats["min"]) + stats["min"]
        return np.cumsum(deltas, axis=-2) if cumsum else deltas
