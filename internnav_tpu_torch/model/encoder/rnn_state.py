"""Recurrent state encoder with episode-boundary masking.

Port of internnav_tpu/model/encoder/rnn_state.py (the reference's
RNNStateEncoder, internnav/model/encoder/rnn_encoder.py:220-384): one
module serves single-step inference (x: (N, in)) and sequence training
(x: (T, N, in), a done-masked loop over time, `ops.rnn`).

States are (N, num_recurrent_layers, H); an LSTM packs (h, c) as two
consecutive layers (the reference's pack_hidden), so agents keep one
homogeneous rnn_states tensor across policy types. The parameters keep
the JAX names (`w_ih`, `w_hh`, `b_ih`, `b_hh`) in torch's layout.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from internnav_tpu_torch.ops.rnn import (
    masked_gru_scan,
    masked_gru_step,
    masked_lstm_scan,
    masked_lstm_step,
)


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, rnn_type: str = "GRU"):
        super().__init__()
        self.rnn_type = rnn_type
        self.hidden_size = hidden_size
        g = (3 if rnn_type == "GRU" else 4) * hidden_size
        # the JAX module's initializers: lecun normal, orthogonal, zeros
        self.w_ih = nn.Parameter(torch.randn(g, input_size) / input_size ** 0.5)
        self.w_hh = nn.Parameter(nn.init.orthogonal_(torch.empty(g, hidden_size)))
        self.b_ih = nn.Parameter(torch.zeros(g))
        self.b_hh = nn.Parameter(torch.zeros(g))

    @property
    def num_recurrent_layers(self) -> int:
        return 1 if self.rnn_type == "GRU" else 2

    def _params(self):
        return {"w_ih": self.w_ih, "w_hh": self.w_hh, "b_ih": self.b_ih, "b_hh": self.b_hh}

    def forward(self, x: torch.Tensor, states: torch.Tensor,
                masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, in) or (T, N, in); states: (N, layers, H); masks: (N,) or
        (T, N), 0 at an episode's first step. Returns (features with x's
        leading dims, new states (N, layers, H))."""
        p = self._params()
        if self.rnn_type == "GRU":
            h = states[:, 0]
            if x.dim() == 2:
                h_new = masked_gru_step(p, x, h, masks)
                return h_new, h_new[:, None]
            ys, h_final = masked_gru_scan(p, x, h, masks)
            return ys, h_final[:, None]
        h, c = states[:, 0], states[:, 1]
        if x.dim() == 2:
            h_new, c_new = masked_lstm_step(p, x, (h, c), masks)
            return h_new, torch.stack([h_new, c_new], dim=1)
        ys, (h_f, c_f) = masked_lstm_scan(p, x, (h, c), masks)
        return ys, torch.stack([h_f, c_f], dim=1)


def build_rnn_state_encoder(input_size: int, hidden_size: int, rnn_type: str = "GRU",
                            **_) -> RNNStateEncoder:
    """Factory with the reference's signature (rnn_encoder.py:364)."""
    return RNNStateEncoder(input_size=input_size, hidden_size=hidden_size,
                           rnn_type=rnn_type.upper())
