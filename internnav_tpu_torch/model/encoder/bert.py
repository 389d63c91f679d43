"""RoBERTa-style text encoder and the cross-modal encoders.

Port of internnav_tpu/model/encoder/bert.py (reference
instruction_roberta_encoder.py:6-32, bert_backbone.py:241-830):

- `RobertaEmbeddings`: word + learned position embeddings at plain arange
  positions (the reference's vendored module; the type-0 token_type row is
  folded into the position table by the converters) + LayerNorm;
- `BertLayer`: post-norm self-attention and GELU MLP;
- `LanguageEncoder`: ids (B, L) → (token embeds, valid mask, first token),
  pad id 1;
- `CrossModalLayer` / `VisionLanguageEncoder`: optional self-attention,
  then cross-attention from q tokens to kv tokens, then the MLP, each
  post-norm; the encoder returns the last layer's first-head cross-attention
  probabilities beside its output.

Parameter names are the JAX tree's (`layer_<i>` as the ModuleList entry
`layer.<i>`). LayerNorm epsilon 1e-5, exact-erf GELU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.encoder.transformer import MultiHeadAttention


class RobertaEmbeddings(nn.Module):
    def __init__(self, vocab_size: int = 50265, hidden_size: int = 768,
                 max_position_embeddings: int = 514, pad_token_id: int = 1,
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        L = input_ids.shape[1]
        positions = torch.arange(L, device=input_ids.device)
        x = self.word_embeddings(input_ids.long()) + self.position_embeddings(positions)[None]
        return self.LayerNorm(x)


class BertLayer(nn.Module):
    """Post-norm BERT encoder layer (bert_backbone.py RobertaLayer:564)."""

    def __init__(self, hidden_size: int = 768, num_heads: int = 12,
                 intermediate_size: int = 3072, layer_norm_eps: float = 1e-5):
        super().__init__()
        self.attention = MultiHeadAttention(hidden_size, num_heads)
        self.attn_ln = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.intermediate = nn.Linear(hidden_size, intermediate_size)
        self.output = nn.Linear(intermediate_size, hidden_size)
        self.out_ln = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, x, key_padding_mask=None):
        x = self.attn_ln(x + self.attention(x, x, x, key_padding_mask))
        return self.out_ln(x + self.output(F.gelu(self.intermediate(x))))


class LanguageEncoder(nn.Module):
    """token ids (B, L) → (token embeds (B, L, H), valid mask (B, L), cls (B, H))."""

    def __init__(self, vocab_size: int = 50265, hidden_size: int = 768, num_layers: int = 6,
                 num_heads: int = 12, intermediate_size: int = 3072, pad_token_id: int = 1,
                 max_position_embeddings: int = 514):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.embeddings = RobertaEmbeddings(vocab_size, hidden_size, max_position_embeddings,
                                            pad_token_id)
        self.layer = nn.ModuleList(BertLayer(hidden_size, num_heads, intermediate_size)
                                   for _ in range(num_layers))

    def forward(self, input_ids) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        valid = input_ids != self.pad_token_id
        x = self.embeddings(input_ids)
        for layer in self.layer:
            x = layer(x, ~valid)
        return x, valid, x[:, 0, :]


class CrossModalLayer(nn.Module):
    """Optional self-attention → cross-attention → FFN, post-norm
    (bert_backbone.py BertCrossLayer:706)."""

    def __init__(self, hidden_size: int = 512, num_heads: int = 8, do_self_attn: bool = True):
        super().__init__()
        self.do_self_attn = do_self_attn
        if do_self_attn:
            self.self_attn = MultiHeadAttention(hidden_size, num_heads)
            self.self_ln = nn.LayerNorm(hidden_size, eps=1e-5)
        self.cross_attn = MultiHeadAttention(hidden_size, num_heads)
        self.cross_ln = nn.LayerNorm(hidden_size, eps=1e-5)
        self.intermediate = nn.Linear(hidden_size, 4 * hidden_size)
        self.output = nn.Linear(4 * hidden_size, hidden_size)
        self.out_ln = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, q_tokens, kv_tokens, q_pad=None, kv_pad=None):
        x = q_tokens
        if self.do_self_attn:
            x = self.self_ln(x + self.self_attn(x, x, x, q_pad))
        h, probs = self.cross_attn(x, kv_tokens, kv_tokens, kv_pad, need_weights=True)
        x = self.cross_ln(x + h)
        x = self.out_ln(x + self.output(F.gelu(self.intermediate(x))))
        return x, probs


class VisionLanguageEncoder(nn.Module):
    """Stack of CrossModalLayers; returns (fused q tokens, first-head
    cross-attention probabilities of the last layer) as the reference's
    output_attentions path (rdp_policy.py:436-452). q_valid / kv_valid:
    (B, T) True = a real token, or None."""

    def __init__(self, hidden_size: int = 512, num_heads: int = 8, num_layers: int = 2,
                 do_self_attn: bool = True):
        super().__init__()
        self.layer = nn.ModuleList(CrossModalLayer(hidden_size, num_heads, do_self_attn)
                                   for _ in range(num_layers))

    def forward(self, q_tokens, kv_tokens, q_valid: Optional[torch.Tensor] = None,
                kv_valid: Optional[torch.Tensor] = None):
        q_pad = None if q_valid is None else ~q_valid.bool()
        kv_pad = None if kv_valid is None else ~kv_valid.bool()
        x, probs = q_tokens, None
        for layer in self.layer:
            x, probs = layer(x, kv_tokens, q_pad, kv_pad)
        return x, probs[:, 0]
