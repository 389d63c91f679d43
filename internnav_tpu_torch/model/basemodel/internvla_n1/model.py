"""InternVLA-N1 dual-system model.

Port of internnav_tpu/model/basemodel/internvla_n1/model.py
(`InternVLAN1Config`, `MemoryEncoder`, `QFormer`, `InternVLAN1Model`):
System-2 is Qwen2.5-VL (text + vision) with learned traj-latent query
tokens; System-1 `nextdit` / `nextdit_async` is the NextDiT flow-matching
Euler denoise conditioned on the projected latents (and, async, on
DINOv2 → MemoryEncoder → QFormer memory tokens); `navdp_async` / `navdp`
is the embedded NavDP head's DDPM denoise (`navdp_head.py`; fp32, async
with an RGBD [memory, current] pair, sync on the latents alone).
Submodule and parameter names follow the JAX module tree, so
`model/weights/from_jax.py` maps one onto the other. Training:
`traj_loss_nextdit` (flow-matching velocity MSE) with the timesteps and
noise passed in; NavDP's loss is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.basemodel.internvla_n1.navdp_head import NavDPHead
from internnav_tpu_torch.model.basemodel.internvla_n1.nextdit import NextDiT, NextDiTConfig
from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import (
    QwenTextConfig,
    QwenTextModel,
)
from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_vision import (
    QwenVisionConfig,
    QwenVisionTower,
)
from internnav_tpu_torch.model.encoder.navdp_backbone import FormerDecoder
from internnav_tpu_torch.model.encoder.transformer import TransformerEncoderLayer
from internnav_tpu_torch.model.encoder.vit import DinoViT
from internnav_tpu_torch.ops.schedulers import FlowMatchEulerScheduler

IMAGE_TOKEN_INDEX = 151655
TRAJ_TOKEN_INDEX = 151667
LATENT_EMB_SIZE = 768


@dataclasses.dataclass(frozen=True)
class InternVLAN1Config:
    text: QwenTextConfig = dataclasses.field(default_factory=QwenTextConfig)
    vision: QwenVisionConfig = dataclasses.field(default_factory=QwenVisionConfig)
    system1: str = "nextdit_async"  # nextdit | nextdit_async | navdp_async | navdp
    n_query: int = 4
    traj_token_index: int = TRAJ_TOKEN_INDEX
    image_token_index: int = IMAGE_TOKEN_INDEX
    num_history: int = 8
    predict_step_nums: int = 32
    #: System-1 frame resolution the DinoViT pos embeds are built for;
    #: frames of another grid are resized to it
    s1_image_hw: int = 56

    @classmethod
    def tiny(cls, system1: str = "nextdit_async", dtype=torch.float32) -> "InternVLAN1Config":
        tc = dataclasses.replace(QwenTextConfig.tiny(), dtype=dtype)
        base = tc.vocab_size - 6  # compact special ids (SimpleTokenizer layout)
        return cls(text=tc, vision=dataclasses.replace(QwenVisionConfig.tiny(), dtype=dtype),
                   system1=system1, n_query=2, predict_step_nums=8,
                   image_token_index=base + 4, traj_token_index=base + 5)

    @classmethod
    def qwen25vl_7b(cls, system1: str = "nextdit_async", weight_dtype: str = "bf16",
                    kv_dtype: str = "bf16", remat: bool = False,
                    num_hidden_layers: Optional[int] = None) -> "InternVLAN1Config":
        """The flagship: true Qwen2.5-VL-7B dims, bf16 activations.
        weight_dtype="int8" selects the W8A8 projections and kv_dtype="int8"
        the int8 KV cache (the `realtime` profile); the vision tower and
        System-1 stay bf16. remat=True recomputes decoder layers in
        backward (training); num_hidden_layers cuts the 28-layer depth
        (never the width)."""
        kw = {} if num_hidden_layers is None else {"num_hidden_layers": num_hidden_layers}
        return cls(text=QwenTextConfig(dtype=torch.bfloat16, weight_dtype=weight_dtype,
                                       kv_dtype=kv_dtype, remat=remat, **kw),
                   vision=QwenVisionConfig(dtype=torch.bfloat16),
                   system1=system1, s1_image_hw=224)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.dtype


class MemoryEncoder(nn.Module):
    """Post-norm transformer encoder over per-frame image features, with
    torch TransformerEncoderLayer defaults (ff 2048, relu)."""

    def __init__(self, hidden_size: int = 384, num_heads: int = 6, num_layers: int = 3,
                 max_len: int = 512, dim_feedforward: int = 2048, dtype=torch.float32):
        super().__init__()
        self.memory_pos = nn.Parameter(torch.zeros(max_len, hidden_size, dtype=dtype))
        self.layer = nn.ModuleList(
            TransformerEncoderLayer(hidden_size, num_heads, dim_feedforward,
                                    norm_first=False, activation="relu", dtype=dtype)
            for _ in range(num_layers))

    def forward(self, memory):
        x = memory + self.memory_pos[None, : memory.shape[1]]
        for layer in self.layer:
            x = layer(x)
        return x


class QFormer(nn.Module):
    """num_query learned queries cross-attending visual features through a
    post-norm decoder (torch TransformerDecoder defaults)."""

    def __init__(self, num_query: int = 32, hidden_size: int = 768, num_layers: int = 3,
                 num_heads: int = 12, dim_feedforward: int = 2048, dtype=torch.float32):
        super().__init__()
        self.query_tokens = nn.Parameter(torch.zeros(num_query, hidden_size, dtype=dtype))
        self.query_pos = nn.Parameter(torch.zeros(num_query, hidden_size, dtype=dtype))
        self.decoder = FormerDecoder(hidden_size, num_heads, num_layers,
                                     dim_feedforward=dim_feedforward, dtype=dtype)

    def forward(self, visual_feats):
        B = visual_feats.shape[0]
        q = (self.query_tokens + self.query_pos)[None].expand(B, -1, -1)
        return self.decoder(q, visual_feats)


class InternVLAN1Model(nn.Module):
    def __init__(self, cfg: InternVLAN1Config):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.cfg = cfg
        self.s1_image_hw = c.s1_image_hw
        self.language_model = QwenTextModel(c.text)
        self.visual = QwenVisionTower(c.vision)
        self.latent_queries = nn.Parameter(torch.zeros(1, c.n_query, c.text.hidden_size, dtype=dt))
        big = c.text.hidden_size > 512
        if "navdp" in c.system1:
            # fp32 whatever the text model's dtype, as the JAX init makes it
            if big:
                self.navdp = NavDPHead(memory_size=2, vlm_token_dim=c.text.hidden_size,
                                       image_hw=self.s1_image_hw)
            else:
                self.navdp = NavDPHead(memory_size=2, predict_size=8, temporal_depth=2,
                                       token_dim=32, heads=4, vlm_token_dim=c.text.hidden_size,
                                       image_hw=self.s1_image_hw)
            return
        if "nextdit" not in c.system1:
            raise ValueError(f"unknown system1 {c.system1!r}")
        dit_cfg = dataclasses.replace(
            NextDiTConfig(latent_embedding_size=LATENT_EMB_SIZE) if big else NextDiTConfig.tiny(),
            dtype=dt)
        latent = dit_cfg.latent_embedding_size
        self.traj_dit = NextDiT(dit_cfg)
        self.action_encoder = nn.Linear(3, dit_cfg.dim, dtype=dt)
        self.action_decoder = nn.Linear(dit_cfg.dim, 3, dtype=dt)
        self.cond_projector = nn.ModuleList([nn.Linear(c.text.hidden_size, latent, dtype=dt),
                                             nn.Linear(latent, latent, dtype=dt)])
        self.noise_scheduler = FlowMatchEulerScheduler()
        if "async" in c.system1:
            rgb_dim = 384 if big else 32
            self.rgb_model = DinoViT(dim=rgb_dim, depth=12 if big else 2, heads=6 if big else 4,
                                     image_hw=self.s1_image_hw, dtype=dt)
            self.memory_encoder = MemoryEncoder(hidden_size=rgb_dim, num_heads=6 if big else 4,
                                                dtype=dt)
            self.rgb_resampler = QFormer(hidden_size=latent, num_heads=12 if big else 4, dtype=dt)
            # concat(feats, encoded) is 2*rgb_dim wide and feeds the QFormer
            # directly at 7B (384+384 == 768); only tiny configs project it
            self.memory_proj = (nn.Linear(2 * rgb_dim, latent, dtype=dt)
                                if 2 * rgb_dim != latent else nn.Identity())

    # --------------------------------------------------------------- embeds
    def embed_multimodal(self, input_ids, image_embeds=None):
        """Token embedding with the image-token and traj-query scatter.
        input_ids (B, T); image_embeds (N_img, D) in reading order."""
        c = self.cfg
        embeds = self.language_model.embed(
            torch.where(input_ids >= c.text.vocab_size, 0, input_ids))
        B, T, D = embeds.shape
        if image_embeds is not None:
            img_mask = (input_ids == c.image_token_index).reshape(-1)
            flat = embeds.reshape(B * T, D)
            idx = (img_mask.long().cumsum(0) - 1).clamp(0, image_embeds.shape[0] - 1)
            flat = torch.where(img_mask[:, None], image_embeds[idx].to(flat.dtype), flat)
            embeds = flat.reshape(B, T, D)
        traj_mask = input_ids == c.traj_token_index
        pos_in_run = torch.where(traj_mask, (traj_mask.long().cumsum(1) - 1) % c.n_query, 0)
        q_embeds = self.latent_queries[0][pos_in_run]
        return torch.where(traj_mask[..., None], q_embeds.to(embeds.dtype), embeds)

    def encode_vision(self, patches, cos, sin, window_segments, full_segments,
                      window_index, reverse_index, window_block: int = 0, full_block: int = 0):
        return self.visual(patches, cos, sin, window_segments, full_segments,
                           window_index, reverse_index,
                           window_block=window_block, full_block=full_block)

    def traj_queries(self):
        """The learned latent query embeddings (1, n_query, D)."""
        return self.latent_queries

    def prefill(self, inputs_embeds, position_ids, segment_ids=None, *,
                compute_logits: bool = True):
        """Text prefill: (logits, hidden, per-layer KV caches)."""
        return self.language_model(inputs_embeds, position_ids, segment_ids=segment_ids,
                                   compute_logits=compute_logits)

    # ------------------------------------------------------------ system-1
    def _project_latents(self, traj_latents):
        x = self.cond_projector[0](traj_latents.to(self.cfg.dtype))
        return self.cond_projector[1](F.gelu(x, approximate="tanh"))

    def rgb_feats(self, images):
        """DINOv2 patch features: (N, H, W, 3) normalized → (N, P, rgb_dim)."""
        return self.rgb_model(images.to(self.cfg.dtype))

    def memory_tokens_from_feats(self, feats):
        """(B, S*P, rgb_dim) per-frame features → (B, 32, latent) tokens."""
        mem = self.memory_encoder(feats)
        mem = self.memory_proj(torch.cat([feats, mem], dim=-1))
        return self.rgb_resampler(mem)

    def memory_tokens_from_images(self, images_dp):
        """images_dp (B, 2, H, W, 3) [pixel-goal frame, current frame],
        ImageNet-normalized → (B, 32, latent) QFormer tokens."""
        B = images_dp.shape[0]
        feats = self.rgb_feats(images_dp.reshape((-1,) + images_dp.shape[2:]))
        return self.memory_tokens_from_feats(feats.reshape(B, -1, feats.shape[-1]))

    def nextdit_velocity(self, noisy_traj, timestep, z_latents, num_samples: int = 1):
        """noisy_traj (B*num_samples, T, 3) → velocity (B*num_samples, T, 3)."""
        feats = self.action_encoder(noisy_traj.to(self.cfg.dtype))
        T = feats.shape[1]
        feats = feats + _sin_pos_encoding(torch.arange(T, device=feats.device),
                                          feats.shape[-1])[None]
        out = self.traj_dit(feats, timestep, z_latents, num_samples=num_samples)
        return self.action_decoder(out)

    def generate_traj_nextdit(self, traj_latents, images_dp=None, *, x_init,
                              guidance_scale: float = 1.0, num_inference_steps: int = 10,
                              num_sample_trajs: int = 32):
        """Flow-matching Euler denoise from x_init (B*num_sample_trajs, P, 3)."""
        lat = self._project_latents(traj_latents)
        if "async" in self.cfg.system1 and images_dp is not None:
            hidden = torch.cat([self.memory_tokens_from_images(images_dp), lat], dim=1)
        else:
            hidden = lat
        return self._denoise_hidden(hidden, guidance_scale, num_inference_steps,
                                    num_sample_trajs, x_init=x_init)

    def generate_traj_nextdit_cached(self, traj_latents, mem_feats, current_images, *, x_init,
                                     guidance_scale: float = 1.0,
                                     num_inference_steps: int = 10,
                                     num_sample_trajs: int = 32):
        """`generate_traj_nextdit` with the memory frame's DINOv2 features
        already computed (`rgb_feats`, (B, P, rgb_dim)): only the current
        frames (B, H, W, 3), ImageNet-normalized, are encoded here. Equal to
        passing both frames as pixels: the two frames' features are
        concatenated either way. A non-async NextDiT conditions on the
        latents alone. x_init (B*num_sample_trajs, P, 3) is the starting
        noise; a grouped caller hands each cohort block its own draw."""
        lat = self._project_latents(traj_latents)
        if "async" in self.cfg.system1:
            feats = torch.cat([mem_feats, self.rgb_feats(current_images)], dim=1)
            hidden = torch.cat([self.memory_tokens_from_feats(feats), lat], dim=1)
        else:
            hidden = lat
        return self._denoise_hidden(hidden, guidance_scale, num_inference_steps,
                                    num_sample_trajs, x_init=x_init)

    def _denoise_hidden(self, hidden, guidance_scale, num_inference_steps,
                        num_sample_trajs, *, x_init):
        B = hidden.shape[0]
        if guidance_scale == 1.0:
            # u + 1.0 * (c - u) == c: only the conditional branch runs
            def velocity(x, t):
                return self.nextdit_velocity(x, t.expand(B), hidden,
                                             num_samples=num_sample_trajs)
        else:
            cond2 = torch.cat([torch.zeros_like(hidden), hidden], dim=0)

            def velocity(x, t):
                v = self.nextdit_velocity(torch.cat([x, x], dim=0), t.expand(2 * B), cond2,
                                          num_samples=num_sample_trajs)
                v_u, v_c = v[: x.shape[0]].float(), v[x.shape[0]:].float()
                return v_u + guidance_scale * (v_c - v_u)

        return self.noise_scheduler.denoise(velocity, x_init.float(), num_inference_steps)

    def generate_traj_navdp(self, traj_latents, images_dp=None, depths_dp=None, *, x_init,
                            step_noises):
        """The NavDP System-1 of the first stream: async on its RGBD pair
        (images_dp (1, 2, H, W, 3) in [0, 1], depths_dp (1, 2, H, W, 1)),
        sync on its latents alone → (sample_num, P, 3) from x_init
        (sample_num, P, 3) and step_noises (steps, sample_num, P, 3)."""
        if "async" in self.cfg.system1:
            return self.navdp.predict_pointgoal_action_async(
                traj_latents, images_dp, depths_dp, x_init=x_init, step_noises=step_noises)
        return self.navdp.predict_pointgoal_action(traj_latents, x_init=x_init,
                                                   step_noises=step_noises)

    def generate_traj_navdp_batched(self, traj_latents, images_dp=None, depths_dp=None, *,
                                    x_init, step_noises, sample_num: int = 32):
        """B streams through one NavDP denoise: traj_latents (B, L, D),
        images / depths (B, 2, H, W, C) for the async variant → (B·sample_num,
        P, 3), row block i conditioned on stream i."""
        if "async" in self.cfg.system1:
            return self.navdp.predict_pointgoal_action_async_batched(
                traj_latents, images_dp, depths_dp, x_init=x_init, step_noises=step_noises,
                sample_num=sample_num)
        return self.navdp.predict_pointgoal_action_batched(
            traj_latents, x_init=x_init, step_noises=step_noises, sample_num=sample_num)

    # ------------------------------------------------------------- training
    def traj_loss_nextdit(self, traj_hidden, traj_poses, *, t, noise, images_dp=None,
                          loss_mask=None):
        """Flow-matching velocity MSE. traj_hidden (B, n_query, D_text);
        traj_poses (B, P, 3); t (B,) integer timesteps in
        [0, num_train_timesteps) and noise (B, P, 3), both drawn by the
        caller; loss_mask (B,) weights whole samples."""
        if loss_mask is None:
            loss_mask = torch.ones(traj_poses.shape[0], device=traj_poses.device)
        num = self.traj_loss_nextdit_sum(traj_hidden, traj_poses, t=t, noise=noise,
                                         images_dp=images_dp, loss_mask=loss_mask)
        return num / loss_mask.float().sum().clamp(min=1e-6)

    def traj_loss_nextdit_sum(self, traj_hidden, traj_poses, *, t, noise, loss_mask,
                              images_dp=None):
        """`traj_loss_nextdit`'s numerator: the masked squared velocity
        error summed over samples and averaged over the (P, 3) entries of
        each. A trainer that splits the samples across micro-batches or
        ranks divides it by loss_mask's sum over all of them."""
        lat = self._project_latents(traj_hidden)
        if "async" in self.cfg.system1 and images_dp is not None:
            lat = torch.cat([self.memory_tokens_from_images(images_dp), lat], dim=1)
        B = traj_poses.shape[0]
        sched = self.noise_scheduler
        noisy = sched.add_noise(traj_poses, noise, t)
        v_pred = self.nextdit_velocity(noisy, t.float(), lat)
        mse = (v_pred.float() - sched.velocity_target(traj_poses, noise).float()) ** 2
        w = loss_mask.reshape(B, 1, 1).float()
        return (mse * w).sum() / (mse.shape[1] * mse.shape[2])


def _sin_pos_encoding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=positions.device) / half)
    ang = positions.float()[:, None] * freqs[None]
    return torch.cat([ang.sin(), ang.cos()], dim=-1)
