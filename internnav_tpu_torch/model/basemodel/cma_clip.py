"""CMA-CLIP: CMA with a transformer text encoder and the CLIP image tower.

Port of internnav_tpu/model/basemodel/cma_clip.py (reference
internnav/model/basemodel/cma/cma_clip_policy.py, CMA_CLIP_Net): CMA's
two-GRU cross-attention structure (`cma.scaled_masked_attention`) with the
GloVe LSTM replaced by a LongCLIP / RoBERTa-style text encoder whose
per-token features are projected to 256 (`txt_proj`, the reference's
txt_linear_512_to_256), and the RGB ResNet by the CLIP visual tower: its
class token feeds the first GRU, its patch tokens the RGB attention. The
text pad mask is the tokenizer's valid mask. Called with single-step
(N, ...) observations or a (T, N, ...) sequence, as `CMANet`.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.configs.model import ModelCfg
from internnav_tpu_torch.model.basemodel.cma import (
    DEPTH_HW,
    RGB_HW,
    RecurrentPolicy,
    _prev_action_index,
    _SeqMode,
    scaled_masked_attention,
)
from internnav_tpu_torch.model.basemodel.rdp import text_encoder_of
from internnav_tpu_torch.model.encoder.clip_vit import CLIPVisionTower, clip_pixels
from internnav_tpu_torch.model.encoder.resnet import VlnResnetDepthEncoder
from internnav_tpu_torch.model.encoder.rnn_state import RNNStateEncoder


class CMACLIPNet(nn.Module):
    """Observations → (logits, rnn_states_out, progress); rnn_states (N,
    2, H); masks 0 at an episode's first step."""

    def __init__(self, cfg: ModelCfg, depth_hw: int = DEPTH_HW, rgb_hw: int = RGB_HW):
        super().__init__()
        c = cfg
        H = c.state_encoder.hidden_size
        text_w = c.text_encoder.hidden_size
        vit_w = getattr(c, "vit_width", 768)
        self.instruction_encoder = text_encoder_of(c, text_w)
        self.txt_proj = nn.Linear(text_w, 256)
        self.rgb_tower = CLIPVisionTower(vit_w, getattr(c, "vit_layers", 12),
                                         getattr(c, "vit_heads", 12), image_hw=rgb_hw)
        self.depth_encoder = VlnResnetDepthEncoder(output_size=c.image_encoder.depth.output_size,
                                                   spatial_output=True, input_hw=depth_hw)
        rgb_out, depth_out = c.image_encoder.rgb.output_size, c.image_encoder.depth.output_size
        depth_c = self.depth_encoder.out_channels
        self.prev_action_embed = nn.Embedding(c.num_actions + 1, 32)
        self.rgb_linear = nn.Linear(vit_w, rgb_out)
        self.depth_linear = nn.Linear(self.depth_encoder.n_tokens * depth_c, depth_out)
        self.state_encoder = RNNStateEncoder(rgb_out + depth_out + 32, H,
                                             c.state_encoder.rnn_type)
        self.rgb_kv = nn.Linear(vit_w, H // 2 + rgb_out)
        self.depth_kv = nn.Linear(depth_c, H // 2 + depth_out)
        self.state_q = nn.Linear(H, H // 2)
        self.text_k = nn.Linear(256, H // 2)
        self.text_q = nn.Linear(256, H // 2)
        self.second_state_compress = nn.Linear(H + 256 + rgb_out + depth_out + 32, H)
        self.second_state_encoder = RNNStateEncoder(H, H, c.state_encoder.rnn_type)
        self.progress_monitor = nn.Linear(H, 1)
        self.action_head = nn.Linear(H, c.num_actions)
        self._scale = (H // 2) ** -0.5
        self._H = H

    def forward(self, observations: Dict[str, torch.Tensor], rnn_states: torch.Tensor,
                prev_actions: torch.Tensor, masks: torch.Tensor):
        sm = _SeqMode(observations["rgb"])
        txt, txt_valid, _ = self.instruction_encoder(sm.flat(observations["instruction"]))
        instr_emb = self.txt_proj(txt)  # (B, L, 256)
        rgb_tokens = self.rgb_tower(clip_pixels(sm.flat(observations["rgb"])))
        depth_tokens = self.depth_encoder(sm.flat(observations["depth"]))
        prev_act = self.prev_action_embed(_prev_action_index(sm.flat(prev_actions),
                                                             sm.flat(masks)))
        rgb_in = F.relu(self.rgb_linear(rgb_tokens[:, 0]))  # the class token
        depth_in = F.relu(self.depth_linear(depth_tokens.reshape(depth_tokens.shape[0], -1)))
        state_in = torch.cat([rgb_in, depth_in, prev_act], dim=1)

        state, h1 = self.state_encoder(sm.unflat(state_in), rnn_states[:, :1], masks)
        state = sm.flat(state)
        text_emb = scaled_masked_attention(self.state_q(state), self.text_k(instr_emb),
                                           instr_emb, ~txt_valid, self._scale)
        half = self._H // 2
        rgb_kv, depth_kv = self.rgb_kv(rgb_tokens[:, 1:]), self.depth_kv(depth_tokens)
        tq = self.text_q(text_emb)
        rgb_att = scaled_masked_attention(tq, rgb_kv[..., :half], rgb_kv[..., half:], None,
                                          self._scale)
        depth_att = scaled_masked_attention(tq, depth_kv[..., :half], depth_kv[..., half:],
                                            None, self._scale)
        x = torch.cat([state, text_emb, rgb_att, depth_att, prev_act], dim=1)
        x = F.relu(self.second_state_compress(x))
        x2, h2 = self.second_state_encoder(sm.unflat(x), rnn_states[:, 1:], masks)
        x2 = sm.flat(x2)
        progress = torch.tanh(self.progress_monitor(x2))
        logits = self.action_head(x2)
        return sm.unflat(logits), torch.cat([h1, h2], dim=1), sm.unflat(progress)


class CMACLIPPolicy(RecurrentPolicy):
    """The JAX package has no default config or agent for it: build it
    from a ModelCfg (text_encoder.model_name "clip-long" for LongCLIP)."""

    name = "CMA_CLIP_Policy"
    net_cls = CMACLIPNet

    def num_recurrent_layers(self) -> int:
        return 2
