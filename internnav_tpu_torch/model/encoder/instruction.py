"""Instruction encoder: GloVe-sized embedding + a uni- or bidirectional
LSTM / GRU over the tokens.

Port of internnav_tpu/model/encoder/instruction.py (reference
internnav/model/encoder/instruction_encoder.py:13-92). Lengths are the
count of nonzero tokens (PAD = 0; a zero inside a row still counts the row
as that many tokens from its start, as in JAX). Each direction is one
batch_first `nn.LSTM` / `nn.GRU` run over the padded rows by
`ops.rnn.encode_padded`: the forward one as is, the backward one over each
row reversed within its own length, its outputs un-reversed; positions past
a row's length are exact zeros, which CMA reads as text padding.

Parameter names: `embedding_layer.weight` and `encoder_rnn.*_l0` as in the
reference; the backward direction's are `encoder_rnn_reverse.*_l0` (the
reference's `encoder_rnn.*_l0_reverse`).
"""

from __future__ import annotations

import gzip
import json

import numpy as np
import torch
from torch import nn

from internnav_tpu_torch.ops.rnn import encode_padded


def load_glove_embeddings(path: str) -> np.ndarray:
    """Load the R2R GloVe embedding table (json.gz, rows = vocab)."""
    with gzip.open(path, "rt") as f:
        return np.asarray(json.load(f), dtype=np.float32)


class InstructionEncoder(nn.Module):
    """Token ids (B, L) → final state (B, H·dirs) or padded outputs
    (B, L, H·dirs)."""

    def __init__(self, vocab_size: int = 2504, embedding_size: int = 50,
                 hidden_size: int = 128, rnn_type: str = "LSTM",
                 final_state_only: bool = True, bidirectional: bool = False):
        super().__init__()
        self.vocab_size = vocab_size
        self.final_state_only = final_state_only
        self.bidirectional = bidirectional
        self.hidden_size = hidden_size
        self.embedding_layer = nn.Embedding(vocab_size, embedding_size)
        rnn_cls = nn.GRU if rnn_type == "GRU" else nn.LSTM
        self.encoder_rnn = rnn_cls(embedding_size, hidden_size, batch_first=True)
        self.encoder_rnn_reverse = (rnn_cls(embedding_size, hidden_size, batch_first=True)
                                    if bidirectional else None)

    @property
    def output_size(self) -> int:
        return self.hidden_size * (2 if self.bidirectional else 1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        lengths = (tokens != 0).sum(dim=1)
        embedded = self.embedding_layer(tokens.clamp(0, self.vocab_size - 1))
        fwd = encode_padded(self.encoder_rnn, embedded, lengths, self.final_state_only)
        if not self.bidirectional:
            return fwd
        bwd = encode_padded(self.encoder_rnn_reverse, embedded, lengths,
                            self.final_state_only, reverse=True)
        return torch.cat([fwd, bwd], dim=-1)
