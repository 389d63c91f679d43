"""Entry point of the port: the port's counterpart of `__graft_entry__.entry()`.

    fn, args = entry(); logits, traj = fn(*args)

One dual-system forward step of InternVLA-N1 on the GPU at a small config:
System-2 prefill of a prompt with four image tokens and the trajectory
queries → traj latents → System-1 NextDiT flow-matching denoise → the
sampled trajectories. The small config keeps the 7B's structure (4 text
layers, a 4-block vision tower with one full-attention block, GQA, the
NextDiT System-1) at widths whose attention head dims are the ones the
prefill kernel takes (128 for text, 80 for vision). Weights are random
from seed 0, drawn on the host and moved to the device, so every device
runs the same weights; `params=` loads a JAX-layout parameter tree instead
(`model/weights/from_jax`). `entry(device="cpu")` runs the plain versions
on the host (the tests); without a device it asks for the GPU and raises
without one.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import QwenTextConfig
from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_vision import QwenVisionConfig


def small_n1_config(dtype: torch.dtype = torch.bfloat16) -> InternVLAN1Config:
    """`__graft_entry__._small_n1_config`'s structure (bf16 by default), at
    widths with 128-wide text heads and 80-wide vision heads."""
    text = QwenTextConfig(vocab_size=2048, hidden_size=512, intermediate_size=1024,
                          num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                          head_dim=128, mrope_section=(16, 24, 24), dtype=dtype)
    vision = QwenVisionConfig(depth=4, hidden_size=160, intermediate_size=320, num_heads=2,
                              window_size=56, fullatt_block_indexes=(3,), out_hidden_size=512,
                              dtype=dtype)
    base = text.vocab_size - 6  # compact special ids (SimpleTokenizer layout)
    return InternVLAN1Config(text=text, vision=vision, system1="nextdit", n_query=4,
                             predict_step_nums=16, image_token_index=base + 4,
                             traj_token_index=base + 5)


def entry(device=None, *, dtype: torch.dtype = torch.bfloat16,
          params: Optional[Mapping[str, Any]] = None) -> Tuple[Callable, tuple]:
    """(fn, args): fn(*args) → (logits (1, 64, vocab), trajectories (4,
    16, 3)) of one forward step of the small policy in `dtype` on
    `device`, with the seed-0 weights or `params`."""
    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.model.weights.from_jax import load_from_jax

    dev = require_cuda() if device is None else torch.device(device)
    cfg = small_n1_config(dtype)
    model = InternVLAN1Policy.build(cfg, device="cpu").model
    if params is not None:
        load_from_jax(model, params)
    model = model.to(dev)
    B, T = 1, 64
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 1024, (B, T))
    ids[0, 4:8] = cfg.image_token_index  # 4 image tokens (one 56x56 frame)
    ids[0, -cfg.n_query:] = cfg.traj_token_index
    img_embeds = torch.from_numpy(rs.randn(4, cfg.text.hidden_size)).to(dev, dtype)
    pos = torch.arange(T, device=dev)[None, None].expand(3, B, T)
    x_init = torch.from_numpy(rs.randn(4, cfg.predict_step_nums, 3)).float().to(dev)

    @torch.inference_mode()
    def forward(input_ids, img_embeds, pos, x_init):
        embeds = model.embed_multimodal(input_ids, img_embeds)
        logits, hidden, _ = model.prefill(embeds, pos)
        latents = hidden[:, -cfg.n_query:, :]
        traj = model.generate_traj_nextdit(latents, x_init=x_init, num_inference_steps=4,
                                           num_sample_trajs=4)
        return logits, traj

    return forward, (torch.from_numpy(ids).to(dev), img_embeds, pos, x_init)
