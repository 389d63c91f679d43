"""NavDP backbone parts (port of internnav_tpu/model/encoder/navdp_backbone.py
`FormerDecoder`, its post-norm branch — the one the QFormer runs)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.encoder.transformer import MultiHeadAttention


class FormerDecoder(nn.Module):
    """N-layer post-norm torch TransformerDecoder (batch_first). LayerNorms
    use flax's default eps 1e-6, as the JAX module does."""

    def __init__(self, dim: int, heads: int, layers: int, dim_feedforward: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.layers = layers
        ff = dim_feedforward or 4 * dim
        for i in range(layers):
            self.add_module(f"layer_{i}_self", MultiHeadAttention(dim, heads, dtype))
            self.add_module(f"layer_{i}_ln1", nn.LayerNorm(dim, eps=1e-6, dtype=dtype))
            self.add_module(f"layer_{i}_cross", MultiHeadAttention(dim, heads, dtype))
            self.add_module(f"layer_{i}_ln2", nn.LayerNorm(dim, eps=1e-6, dtype=dtype))
            self.add_module(f"layer_{i}_ff1", nn.Linear(dim, ff, dtype=dtype))
            self.add_module(f"layer_{i}_ff2", nn.Linear(ff, dim, dtype=dtype))
            self.add_module(f"layer_{i}_ln3", nn.LayerNorm(dim, eps=1e-6, dtype=dtype))

    def forward(self, tgt, memory):
        x = tgt
        for i in range(self.layers):
            m = lambda name: getattr(self, f"layer_{i}_{name}")  # noqa: E731
            x = m("ln1")(x + m("self")(x, x, x))
            x = m("ln2")(x + m("cross")(x, memory, memory))
            x = m("ln3")(x + m("ff2")(F.relu(m("ff1")(x))))
        return x
