"""Recurrent cells, done-masked stepping and variable-length encoding.

Port of internnav_tpu/ops/rnn.py (the reference's packed-sequence RNN
machinery, internnav/model/encoder/rnn_encoder.py and
instruction_encoder.py:82-92). Parameters are dicts in torch's layout and
gate order (GRU: r, z, n; LSTM: i, f, g, o): `w_ih` (G·H, in), `w_hh`
(G·H, H), `b_ih`, `b_hh` (G·H,).

- The cells are torch's own (`torch.gru_cell` / `torch.lstm_cell`), the
  JAX package's formulas.
- A masked step multiplies the carry by the step's mask *before* the cell
  (0 marks an episode's first step), as the reference's
  `hidden_states * masks` does; a masked scan runs that step over time.
- A padded encode runs an `nn.GRU` / `nn.LSTM` (batch_first; cuDNN on the
  card) over the whole padded sequence in one call and keeps what the JAX
  package's length-masked scan keeps: the outputs at positions below each
  row's length (a position's state has seen only the tokens before it),
  exact zeros past it, and the state at position length - 1 as the final
  state (zeros for a row of length 0). The backward direction reverses
  each row within its own length, encodes, and un-reverses the outputs
  (`reverse=True`). Nothing reads the lengths on the host, so a forward
  that encodes an instruction queues its work without waiting for the
  device.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
from torch import nn

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------------- cells
def gru_cell(params: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step, torch semantics. x: (N, in), h: (N, H) → (N, H)."""
    return torch.gru_cell(x, h, params["w_ih"], params["w_hh"], params["b_ih"], params["b_hh"])


def lstm_cell(params: Params, x: torch.Tensor,
              state: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step, torch gate order (i, f, g, o). Returns (h, c)."""
    h, c = torch.lstm_cell(x, state, params["w_ih"], params["w_hh"], params["b_ih"],
                           params["b_hh"])
    return h, c


# ------------------------------------------- masked single-step / sequence
def _mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(like.shape[0], 1).to(like.dtype)


def masked_gru_step(params: Params, x: torch.Tensor, h: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Zero the carry where mask == 0 (a new episode), then step.
    mask: (N,) or (N, 1) of {0., 1.}."""
    return gru_cell(params, x, h * _mask(mask, h))


def masked_lstm_step(params: Params, x: torch.Tensor,
                     state: Tuple[torch.Tensor, torch.Tensor],
                     mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h, c = state
    m = _mask(mask, h)
    return lstm_cell(params, x, (h * m, c * m))


def masked_gru_scan(params: Params, xs: torch.Tensor, h0: torch.Tensor,
                    masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs: (T, N, in); h0: (N, H); masks: (T, N), 0 at an episode's first
    step. Returns (outputs (T, N, H), final hidden (N, H))."""
    h, ys = h0, []
    for t in range(xs.shape[0]):
        h = masked_gru_step(params, xs[t], h, masks[t])
        ys.append(h)
    return torch.stack(ys), h


def masked_lstm_scan(params: Params, xs: torch.Tensor,
                     state0: Tuple[torch.Tensor, torch.Tensor], masks: torch.Tensor):
    """As masked_gru_scan; returns (hidden outputs (T, N, H), (h, c))."""
    state, ys = state0, []
    for t in range(xs.shape[0]):
        state = masked_lstm_step(params, xs[t], state, masks[t])
        ys.append(state[0])
    return torch.stack(ys), state


# ------------------------------------------------- variable-length encoder
def valid_positions(lengths: torch.Tensor, L: int) -> torch.Tensor:
    """(N, L) bool: position < the row's length."""
    return torch.arange(L, device=lengths.device)[None, :] < lengths[:, None]


def reverse_within_length(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x (N, L, C) with each row's first `length` positions reversed and
    the rest zero; applied twice it gives back the valid positions."""
    L = x.shape[1]
    pos = torch.arange(L, device=x.device)[None, :]
    idx = (lengths[:, None] - 1 - pos).clamp(0, L - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where(valid_positions(lengths, L)[..., None], out, torch.zeros_like(out))


def encode_padded(rnn: Union[nn.GRU, nn.LSTM], embedded: torch.Tensor, lengths: torch.Tensor,
                  final_state_only: bool = True, reverse: bool = False) -> torch.Tensor:
    """Encode padded (N, L, E) rows of `lengths` valid tokens with a
    one-layer, one-direction batch_first `rnn` from zero state: the state
    at each row's last valid token (N, H), or the outputs (N, L, H) with
    exact zeros past each row's length. `reverse` encodes each row
    backwards within its length (outputs aligned to their tokens)."""
    N, L, _ = embedded.shape
    lengths = lengths.to(device=embedded.device, dtype=torch.long)
    xs = reverse_within_length(embedded, lengths) if reverse else embedded
    ys, _ = rnn(xs)
    if final_state_only:
        last = (lengths - 1).clamp(min=0)
        h = ys[torch.arange(N, device=ys.device), last]
        return torch.where((lengths > 0)[:, None], h, torch.zeros_like(h))
    if reverse:
        return reverse_within_length(ys, lengths)
    return torch.where(valid_positions(lengths, L)[..., None], ys, torch.zeros_like(ys))


def rnn_from_params(kind: str, params: Params) -> Union[nn.GRU, nn.LSTM]:
    """A one-layer batch_first nn.GRU ("GRU") or nn.LSTM ("LSTM") holding
    `params` (w_ih, w_hh, b_ih, b_hh), on their device and dtype."""
    w_ih = params["w_ih"]
    cls = nn.GRU if kind == "GRU" else nn.LSTM
    rnn = cls(w_ih.shape[1], params["w_hh"].shape[1], batch_first=True,
              device=w_ih.device, dtype=w_ih.dtype)
    with torch.no_grad():
        for ours, theirs in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                             ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
            getattr(rnn, theirs).copy_(params[ours])
    return rnn


def gru_encode_padded(params: Params, embedded: torch.Tensor, lengths: torch.Tensor,
                      final_state_only: bool = True) -> torch.Tensor:
    """JAX `gru_encode_padded`: encode_padded with a GRU of `params`."""
    return encode_padded(rnn_from_params("GRU", params), embedded, lengths, final_state_only)


def lstm_encode_padded(params: Params, embedded: torch.Tensor, lengths: torch.Tensor,
                       final_state_only: bool = True) -> torch.Tensor:
    """JAX `lstm_encode_padded`: encode_padded with an LSTM of `params`."""
    return encode_padded(rnn_from_params("LSTM", params), embedded, lengths, final_state_only)
