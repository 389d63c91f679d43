"""LongCLIP text encoder.

Port of internnav_tpu/model/encoder/longclip.py (reference
internnav/model/encoder/instruction_longCLIP_encoder.py:10-77): the
Long-CLIP text transformer with its dual positional embedding (the first
`keep_len` positions take the original CLIP table, the rest
`positional_embedding_res`), context 248, causal pre-LN resblocks with
QuickGELU, `ln_final`, and EOT pooling at argmax(token id) through
`text_projection`. Returns (per-token embeds (B, 248, width), valid mask
(B, 248), pooled (B, projection_dim)).

`convert_longclip_text` maps a Long-CLIP checkpoint's text keys onto the
encoder's state_dict (the JAX function of that name builds the Flax tree).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPResBlock(nn.Module):
    """Pre-LN block with a packed q/k/v projection (`in_proj`) and an
    additive causal mask."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.in_proj = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        hd = D // self.heads
        q, k, v = self.in_proj(self.ln_1(x)).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2) for t in (q, k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5 + causal_mask[None, None]
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
        x = x + self.out_proj(o.transpose(1, 2).reshape(B, L, D))
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class LongCLIPTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 49408, width: int = 512, layers: int = 12,
                 heads: int = 8, context_length: int = 248, projection_dim: int = 512,
                 keep_len: int = 20):
        super().__init__()
        self.context_length = context_length
        self.keep_len = keep_len
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(0.01 * torch.randn(context_length, width))
        self.positional_embedding_res = nn.Parameter(0.01 * torch.randn(context_length, width))
        self.resblock = nn.ModuleList(CLIPResBlock(width, heads) for _ in range(layers))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(0.01 * torch.randn(width, projection_dim))

    def forward(self, input_ids: torch.Tensor, txt_masks: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """input_ids (B, L ≤ 248), right-padded with 0 to 248 as the
        reference does (instruction_longCLIP_encoder.py:60-63)."""
        ids = input_ids.long()
        ctx = self.context_length
        if ids.shape[1] < ctx:
            ids = F.pad(ids, (0, ctx - ids.shape[1]))
        if txt_masks is None:
            txt_masks = ids != 0
        keep = (torch.arange(ctx, device=ids.device) < self.keep_len)[:, None]
        pos = self.positional_embedding * keep + self.positional_embedding_res * ~keep
        x = self.token_embedding(ids) + pos
        causal = torch.full((ctx, ctx), float("-inf"), device=ids.device).triu(1)
        for block in self.resblock:
            x = block(x, causal)
        x = self.ln_final(x)
        eot = ids.argmax(dim=-1)  # EOT has the highest id in the CLIP vocab
        cls = x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection
        return x.float(), txt_masks, cls.float()


def convert_longclip_text(sd: Mapping[str, torch.Tensor], prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """A Long-CLIP checkpoint's text keys (token_embedding.weight,
    positional_embedding[_res], transformer.resblocks.N.{ln_1, attn.in_proj_
    weight/bias, attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}, ln_final,
    text_projection) → `LongCLIPTextEncoder`'s state_dict names."""
    out = {"token_embedding.weight": sd[prefix + "token_embedding.weight"]}
    for name in ("positional_embedding", "positional_embedding_res", "text_projection"):
        out[name] = sd[prefix + name]
    for leaf in ("weight", "bias"):
        out[f"ln_final.{leaf}"] = sd[f"{prefix}ln_final.{leaf}"]
    i = 0
    while f"{prefix}transformer.resblocks.{i}.ln_1.weight" in sd:
        src, dst = f"{prefix}transformer.resblocks.{i}.", f"resblock.{i}."
        for leaf in ("weight", "bias"):
            out[dst + f"in_proj.{leaf}"] = sd[src + f"attn.in_proj_{leaf}"]
            for ours, theirs in (("ln_1", "ln_1"), ("ln_2", "ln_2"), ("out_proj", "attn.out_proj"),
                                 ("c_fc", "mlp.c_fc"), ("c_proj", "mlp.c_proj")):
                out[dst + f"{ours}.{leaf}"] = sd[src + f"{theirs}.{leaf}"]
        i += 1
    return out
