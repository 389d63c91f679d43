"""Seq2Seq baseline VLN policy.

Port of internnav_tpu/model/basemodel/seq2seq.py (reference
internnav/model/basemodel/seq2seq/seq2seq_policy.py, Seq2SeqNet:64-236):
the final state of the bi-LSTM instruction encoder, the non-spatial DD-PPO
depth tower (128), the non-spatial ResNet-50 RGB tower (256) [and a
prev-action embedding] → one GRU (512) → action logits and a tanh
progress head.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from internnav_tpu_torch.configs.model import ModelCfg
from internnav_tpu_torch.model.basemodel.cma import (
    DEPTH_HW,
    RecurrentPolicy,
    _prev_action_index,
    _SeqMode,
)
from internnav_tpu_torch.model.encoder.instruction import InstructionEncoder
from internnav_tpu_torch.model.encoder.resnet import TorchVisionResNet, VlnResnetDepthEncoder
from internnav_tpu_torch.model.encoder.rnn_state import RNNStateEncoder


class Seq2SeqNet(nn.Module):
    def __init__(self, cfg: ModelCfg, use_prev_action: bool = False, depth_hw: int = DEPTH_HW):
        super().__init__()
        c, tc = cfg, cfg.text_encoder
        self.use_prev_action = use_prev_action
        self.instruction_encoder = InstructionEncoder(
            vocab_size=tc.vocab_size, embedding_size=tc.embedding_size,
            hidden_size=tc.rnn_hidden_size, rnn_type="LSTM", final_state_only=True,
            bidirectional=tc.bidirectional)
        self.rgb_encoder = TorchVisionResNet(version=c.image_encoder.rgb.model_name,
                                             output_size=c.image_encoder.rgb.output_size,
                                             normalize_visual_inputs=c.normalize_rgb,
                                             spatial_output=False)
        self.depth_encoder = VlnResnetDepthEncoder(output_size=c.image_encoder.depth.output_size,
                                                   spatial_output=False, input_hw=depth_hw)
        if use_prev_action:
            self.prev_action_embed = nn.Embedding(c.num_actions + 1, 32)
        self.state_encoder = RNNStateEncoder(
            self.instruction_encoder.output_size + c.image_encoder.depth.output_size
            + c.image_encoder.rgb.output_size + (32 if use_prev_action else 0),
            c.state_encoder.hidden_size, c.state_encoder.rnn_type)
        self.progress_monitor = nn.Linear(c.state_encoder.hidden_size, 1)
        self.action_head = nn.Linear(c.state_encoder.hidden_size, c.num_actions)

    def forward(self, observations: Dict[str, torch.Tensor], rnn_states: torch.Tensor,
                prev_actions: torch.Tensor, masks: torch.Tensor):
        sm = _SeqMode(observations["rgb"])
        feats = [self.instruction_encoder(sm.flat(observations["instruction"])),
                 self.depth_encoder(sm.flat(observations["depth"])),
                 self.rgb_encoder(sm.flat(observations["rgb"]))]
        if self.use_prev_action:
            feats.append(self.prev_action_embed(_prev_action_index(sm.flat(prev_actions),
                                                                   sm.flat(masks))))
        out, h = self.state_encoder(sm.unflat(torch.cat(feats, dim=1)), rnn_states, masks)
        out = sm.flat(out)
        logits = self.action_head(out)
        progress = torch.tanh(self.progress_monitor(out))
        return sm.unflat(logits), h, sm.unflat(progress)


class Seq2SeqPolicy(RecurrentPolicy):
    name = "Seq2Seq_Policy"
    REFERENCE_CONVERTER_NAME = "convert_seq2seq_policy"
    net_cls = Seq2SeqNet

    def num_recurrent_layers(self) -> int:
        return 1
