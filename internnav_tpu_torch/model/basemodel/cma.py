"""CMA (Cross-Modal Attention) VLN policy.

Port of internnav_tpu/model/basemodel/cma.py (reference
internnav/model/basemodel/cma/cma_policy.py: CMANet:67, _attn:261-266,
_forward:268-325):

  instruction --bi-LSTM--> per-token features (zeros at pad)
  rgb   --TorchVisionResNet (spatial)--> 16 tokens x (2048 + 64)
  depth --DD-PPO GN-ResNet-50 (spatial)--> 16 tokens x (128 + 64)
  [rgb pool, depth flatten, prev_action] --GRU #1--> state
  state -q-> text attention -> text_emb -q-> rgb / depth attention
  concat --compress--> GRU #2 --> action logits + tanh progress

As in JAX: token-major (B, T, C) features, the reference's 1x1 Conv1d k/v
projections as Linear layers on tokens, the depth tokens flattened
token-major into `depth_linear`. Called with single-step (N, ...)
observations or a sequence (T, N, ...): both GRUs then run a done-masked
loop over time and the attention runs per frame.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.configs.model import ModelCfg
from internnav_tpu_torch.model.base import Policy, resolve_device
from internnav_tpu_torch.model.encoder.instruction import InstructionEncoder
from internnav_tpu_torch.model.encoder.resnet import TorchVisionResNet, VlnResnetDepthEncoder
from internnav_tpu_torch.model.encoder.rnn_state import RNNStateEncoder

#: the frame sizes the policies are built for (reference observation
#: space, cma_policy.py:130-135): the depth tower flattens its grid, so
#: depth must arrive at this size
RGB_HW = 224
DEPTH_HW = 256


def scaled_masked_attention(q, k, v, mask=None, scale=None):
    """Reference CMA _attn: logits q·k_t, minus 1e8 where masked, softmax
    over tokens of logits * scale, output Σ attn·v. q: (B, C); k: (B, T, C);
    v: (B, T, Cv); mask: (B, T) True = masked out."""
    logits = torch.einsum("bc,btc->bt", q, k)
    if mask is not None:
        logits = logits - mask.to(logits.dtype) * 1e8
    attn = torch.softmax(logits * scale, dim=1)
    return torch.einsum("bt,btc->bc", attn, v)


def _prev_action_index(prev_actions, masks) -> torch.Tensor:
    """(prev_action + 1) * mask: 0 at an episode's first step."""
    pa, m = prev_actions.reshape(-1), masks.reshape(-1)
    return ((pa.float() + 1.0) * m.float()).long()


class _SeqMode:
    """Flatten (T, N, ...) observations to (T·N, ...) and back."""

    def __init__(self, rgb: torch.Tensor):
        self.seq = rgb.dim() == 5
        self.T, self.N = (rgb.shape[:2] if self.seq else (1, rgb.shape[0]))

    def flat(self, x):
        return x.reshape((self.T * self.N,) + tuple(x.shape[2:])) if self.seq else x

    def unflat(self, x):
        return x.reshape((self.T, self.N) + tuple(x.shape[1:])) if self.seq else x


class CMANet(nn.Module):
    """Observations → (logits, rnn_states_out, progress). rnn_states:
    (N, 2, H); masks: 0 at an episode's first step. `depth_hw` is the
    depth frame's side (the JAX package builds at 256)."""

    def __init__(self, cfg: ModelCfg, depth_hw: int = DEPTH_HW):
        super().__init__()
        c, tc = cfg, cfg.text_encoder
        self.instruction_encoder = InstructionEncoder(
            vocab_size=tc.vocab_size, embedding_size=tc.embedding_size,
            hidden_size=tc.rnn_hidden_size, rnn_type="LSTM", final_state_only=False,
            bidirectional=tc.bidirectional)
        self.rgb_encoder = TorchVisionResNet(version=c.image_encoder.rgb.model_name,
                                             normalize_visual_inputs=c.normalize_rgb,
                                             spatial_output=True)
        self.depth_encoder = VlnResnetDepthEncoder(output_size=c.image_encoder.depth.output_size,
                                                   spatial_output=True, input_hw=depth_hw)
        H = c.state_encoder.hidden_size
        rgb_out, depth_out = c.image_encoder.rgb.output_size, c.image_encoder.depth.output_size
        rgb_c = self.rgb_encoder.final_channels + 64
        depth_c = self.depth_encoder.out_channels
        text_c = self.instruction_encoder.output_size
        self.prev_action_embed = nn.Embedding(c.num_actions + 1, 32)
        self.rgb_linear = nn.Linear(rgb_c, rgb_out)
        self.depth_linear = nn.Linear(self.depth_encoder.n_tokens * depth_c, depth_out)
        self.state_encoder = RNNStateEncoder(rgb_out + depth_out + 32, H,
                                             c.state_encoder.rnn_type)
        self.rgb_kv = nn.Linear(rgb_c, H // 2 + rgb_out)
        self.depth_kv = nn.Linear(depth_c, H // 2 + depth_out)
        self.state_q = nn.Linear(H, H // 2)
        self.text_k = nn.Linear(text_c, H // 2)
        self.text_q = nn.Linear(text_c, H // 2)
        self.second_state_compress = nn.Linear(H + text_c + rgb_out + depth_out + 32, H)
        self.second_state_encoder = RNNStateEncoder(H, H, c.state_encoder.rnn_type)
        self.progress_monitor = nn.Linear(H, 1)
        self.action_head = nn.Linear(H, c.num_actions)
        self._scale = (H // 2) ** -0.5
        self._H = H

    def forward(self, observations: Dict[str, torch.Tensor], rnn_states: torch.Tensor,
                prev_actions: torch.Tensor, masks: torch.Tensor):
        sm = _SeqMode(observations["rgb"])
        instr_emb = self.instruction_encoder(sm.flat(observations["instruction"]))
        text_pad = (instr_emb == 0.0).all(dim=-1)  # (B, L) True at pad
        rgb_tokens = self.rgb_encoder(sm.flat(observations["rgb"]))
        depth_tokens = self.depth_encoder(sm.flat(observations["depth"]))
        prev_act = self.prev_action_embed(_prev_action_index(sm.flat(prev_actions),
                                                             sm.flat(masks)))
        rgb_in = F.relu(self.rgb_linear(rgb_tokens.mean(dim=1)))
        depth_in = F.relu(self.depth_linear(depth_tokens.reshape(depth_tokens.shape[0], -1)))
        state_in = torch.cat([rgb_in, depth_in, prev_act], dim=1)

        state, h1 = self.state_encoder(sm.unflat(state_in), rnn_states[:, :1], masks)
        state = sm.flat(state)
        text_emb = scaled_masked_attention(self.state_q(state), self.text_k(instr_emb),
                                           instr_emb, text_pad, self._scale)
        half = self._H // 2
        rgb_kv, depth_kv = self.rgb_kv(rgb_tokens), self.depth_kv(depth_tokens)
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


class RecurrentPolicy(Policy):
    """A recurrent VLN policy over `net_cls`: the reference's
    forward(batch) with mode train / inference / features
    (cma_policy.py:327-341)."""

    net_cls: type = nn.Module

    @classmethod
    def build(cls, cfg: ModelCfg, device=None, seed: int = 0, depth_hw: int = DEPTH_HW):
        """A random net (torch's initializers, drawn from `seed`) on
        `device`: the GPU when None; "cpu" only when asked for."""
        device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = cls.net_cls(cfg, depth_hw=depth_hw)
        return cls(net.to(device), cfg)

    @classmethod
    def from_pretrained(cls, path: str, cfg: Optional[ModelCfg] = None, device=None,
                        depth_hw: int = DEPTH_HW):
        """A native directory or a reference-format checkpoint on `device`."""
        cfg = cls.load_config(path, default=cfg)
        pol = cls.build(cfg, device, depth_hw=depth_hw)
        pol.net.load_state_dict(cls.load_params_file(path, pol.net))
        return pol

    def forward(self, batch: Dict[str, Any]):
        """(logits, states, progress), with the argmax (N, 1) in place of
        the logits in mode "inference"; gradients only in mode "train"."""
        mode = batch.get("mode", "features")
        with torch.set_grad_enabled(mode == "train"):
            logits, states, progress = self.net(batch["observations"], batch["rnn_states"],
                                                batch["prev_actions"], batch["masks"])
        if mode == "inference":
            return logits.argmax(dim=-1, keepdim=True), states, progress
        return logits, states, progress


class CMAPolicy(RecurrentPolicy):
    name = "CMA_Policy"
    REFERENCE_CONVERTER_NAME = "convert_cma_policy"
    net_cls = CMANet

    def num_recurrent_layers(self) -> int:
        return 2
