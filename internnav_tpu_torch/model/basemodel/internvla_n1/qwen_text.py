"""Qwen2.5 text decoder — the InternVLA-N1 System-2 LLM (bf16 path).

Port of internnav_tpu/model/basemodel/internvla_n1/qwen_text.py:
RMSNorm, SwiGLU MLP, GQA attention with q/k/v biases, M-RoPE, untied LM
head, cached greedy decode with the rope-delta fast path, the chunked
decode of the traj-latent queries, and for training the per-layer
rematerialization (`QwenTextConfig.remat`) and the chunked full-vocab
cross-entropy (`chunked_ce`).

- Prefill runs `flash_attention` (the Hopper kernel on CUDA) with causal +
  pad-isolating segment ids, on UN-repeated K/V: query head h reads KV head
  h // (H // KV) inside the kernel. The segment ids' tile tables are built
  once per forward and shared by every layer (and their backward).
- Decode writes the new K/V into the preallocated cache IN PLACE (the JAX
  package returns updated copies); the cache is owned by the decode loop.
- Only the bf16 weight / bf16 KV format is ported: `weight_dtype` or
  `kv_dtype` other than "bf16" raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from internnav_tpu_torch.ops.flash_attention import (
    flash_attention,
    gqa_chunk_decode_attention,
    gqa_decode_attention,
    segment_tile_tables,
)
from internnav_tpu_torch.ops.rope import mrope_cos_sin, rotate_half

KVCache = Tuple[torch.Tensor, torch.Tensor]  # (B, T, KV, D) each


@dataclasses.dataclass(frozen=True)
class QwenTextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    dtype: torch.dtype = torch.bfloat16
    weight_dtype: str = "bf16"
    kv_dtype: str = "bf16"
    #: recompute each decoder layer in backward (torch.utils.checkpoint)
    #: instead of keeping its activations; the parameter names are unchanged
    remat: bool = False

    def __post_init__(self):
        if self.weight_dtype != "bf16" or self.kv_dtype != "bf16":
            raise NotImplementedError(
                f"weight_dtype={self.weight_dtype!r} / kv_dtype={self.kv_dtype!r}: "
                "only the bf16 format is ported yet (int8/int4 not yet ported)")

    @classmethod
    def tiny(cls) -> "QwenTextConfig":
        """Test-size config (structure-identical)."""
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=16, mrope_section=(2, 3, 3))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def apply_rotary(q, k, cos, sin):
    """q/k (B, H, T, D); cos/sin (B, T, D). Runs in the q/k dtype, like HF."""
    cos = cos[:, None].to(q.dtype)
    sin = sin[:, None].to(q.dtype)
    q_out = q * cos + rotate_half(q) * sin
    k_out = k * cos + rotate_half(k) * sin
    return q_out, k_out.to(k.dtype)


class QwenAttention(nn.Module):
    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        self.cfg = cfg
        H, KV, D, E = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim, cfg.hidden_size)
        self.q_proj = nn.Linear(E, H * D, bias=True, dtype=cfg.dtype)
        self.k_proj = nn.Linear(E, KV * D, bias=True, dtype=cfg.dtype)
        self.v_proj = nn.Linear(E, KV * D, bias=True, dtype=cfg.dtype)
        self.o_proj = nn.Linear(H * D, E, bias=False, dtype=cfg.dtype)

    def forward(self, x, cos, sin, *, segment_ids=None, tile_tables=None,
                kv_cache: Optional[KVCache] = None, cache_len=None):
        """Prefill when kv_cache is None: returns (out, (k, v)) with the new
        cache entries (B, T, KV, D); tile_tables are `segment_tile_tables`
        of segment_ids (built by the kernel wrapper when None). Otherwise x
        holds n >= 1 new tokens whose K/V are written into kv_cache at
        cache_len (B,) in place, each attending stepwise-causally over the
        cache."""
        c = self.cfg
        B, n = x.shape[:2]
        H, KV, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        q = self.q_proj(x).reshape(B, n, H, D).transpose(1, 2)
        k = self.k_proj(x).reshape(B, n, KV, D).transpose(1, 2)
        v = self.v_proj(x).reshape(B, n, KV, D)
        q, k = apply_rotary(q, k, cos, sin)
        if kv_cache is None:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.transpose(1, 2).contiguous(),
                                  causal=True, segment_ids=segment_ids,
                                  tile_tables=tile_tables)
            new_cache = (k.transpose(1, 2), v)
        else:
            k_cache, v_cache = kv_cache
            rows = torch.arange(B, device=x.device)[:, None]
            cols = cache_len.reshape(B, 1) + torch.arange(n, device=x.device)[None]
            k_cache[rows, cols] = k.transpose(1, 2).to(k_cache.dtype)
            v_cache[rows, cols] = v.to(v_cache.dtype)
            kd, vd = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
            if n == 1:
                out = gqa_decode_attention(q[:, :, 0], kd, vd, cache_len + 1)[:, :, None]
            else:
                out = gqa_chunk_decode_attention(q, kd, vd, cache_len)
            new_cache = kv_cache
        out = out.transpose(1, 2).reshape(B, n, H * D)
        return self.o_proj(out), new_cache


class QwenMLP(nn.Module):
    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        E, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(E, I, bias=False, dtype=cfg.dtype)
        self.up_proj = nn.Linear(E, I, bias=False, dtype=cfg.dtype)
        self.down_proj = nn.Linear(I, E, bias=False, dtype=cfg.dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class QwenDecoderLayer(nn.Module):
    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.self_attn = QwenAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.mlp = QwenMLP(cfg)

    def forward(self, x, cos, sin, *, segment_ids=None, tile_tables=None, kv_cache=None,
                cache_len=None):
        h, new_cache = self.self_attn(self.input_layernorm(x), cos, sin,
                                      segment_ids=segment_ids, tile_tables=tile_tables,
                                      kv_cache=kv_cache, cache_len=cache_len)
        x = x + h
        return x + self.mlp(self.post_attention_layernorm(x)), new_cache


class QwenTextModel(nn.Module):
    """Decoder trunk. forward = prefill; `decode_step` / `decode_chunk` =
    cached decode."""

    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype)
        self.layers = nn.ModuleList(QwenDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=cfg.dtype)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids.long())

    def _cos_sin(self, position_ids):
        """M-RoPE tables for (3, B, T) t/h/w position ids."""
        c = self.cfg
        return mrope_cos_sin(position_ids, c.head_dim, c.mrope_section, c.rope_theta)

    def forward(self, inputs_embeds, position_ids, *, segment_ids=None, logits_indices=None,
                compute_logits: bool = True):
        """Prefill. inputs_embeds (B, T, E); position_ids (3, B, T).
        Returns (logits, hidden, caches), caches per layer (k, v) of
        (B, T, KV, D); logits_indices (B,) computes the logits only at those
        positions ((B, 1, vocab)); compute_logits=False returns logits None
        (training with `chunked_ce` never builds the (B, T, vocab) logits).
        With cfg.remat and grad enabled each layer runs under checkpoint and
        is recomputed in backward, and caches is None. The segment ids'
        `segment_tile_tables` are built here once and shared by every
        layer."""
        tile_tables = segment_tile_tables(segment_ids)
        cos, sin = self._cos_sin(position_ids)
        x = inputs_embeds
        remat = self.cfg.remat and torch.is_grad_enabled()
        caches: Optional[List[KVCache]] = None if remat else []
        for layer in self.layers:
            if remat:
                x = checkpoint(_layer_hidden, layer, x, cos, sin, segment_ids, tile_tables,
                               use_reentrant=False)
            else:
                x, cache = layer(x, cos, sin, segment_ids=segment_ids, tile_tables=tile_tables)
                caches.append(cache)
        hidden = self.norm(x)
        if not compute_logits:
            return None, hidden, caches
        if logits_indices is not None:
            rows = torch.arange(hidden.shape[0], device=hidden.device)
            logits = self._logits(hidden[rows, logits_indices.long()])[:, None]
        else:
            logits = self._logits(hidden)
        return logits, hidden, caches

    def _logits(self, hidden):
        return self.lm_head(hidden).float()

    def chunked_ce(self, hidden, labels, *, ignore_index: int, chunk: int = 1024):
        """Mean next-token cross-entropy over the full vocab without the
        (B, T, vocab) fp32 logits: the lm_head and the softmax-CE run per
        `chunk` positions under checkpoint, so one chunk's logits are live
        at a time and backward recomputes them. Same value as the
        full-logits loss on shifted logits / labels."""
        h = hidden[:, :-1]
        lbl = labels[:, 1:]
        tot = hidden.new_zeros((), dtype=torch.float32)
        cnt = hidden.new_zeros((), dtype=torch.float32)
        for start in range(0, h.shape[1], chunk):
            t, c = checkpoint(self._chunk_ce, h[:, start:start + chunk],
                              lbl[:, start:start + chunk], ignore_index, use_reentrant=False)
            tot = tot + t
            cnt = cnt + c
        return tot / cnt.clamp(min=1.0)

    def _chunk_ce(self, h, lbl, ignore_index: int):
        """(sum of CE, count) over the valid labels of one chunk."""
        logits = self._logits(h)
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0).long()
        gold = logits.gather(-1, safe[..., None])[..., 0]
        ce = torch.logsumexp(logits, dim=-1) - gold
        return (ce * valid).sum(), valid.sum().float()

    def _decode(self, token_embeds, position_ids, caches, cache_len):
        cos, sin = self._cos_sin(position_ids)
        x = token_embeds
        for layer, cache in zip(self.layers, caches):
            x, _ = layer(x, cos, sin, kv_cache=cache, cache_len=cache_len)
        return self.norm(x)

    def decode_step(self, token_embeds, position_ids, caches, cache_len,
                    compute_logits: bool = True):
        """One cached decode step: token_embeds (B, 1, E); cache_len (B,) is
        where the new token goes. Returns (logits (B, vocab) or None,
        hidden (B, E), caches) — the caches are updated in place."""
        hidden = self._decode(token_embeds, position_ids, caches, cache_len)
        logits = self._logits(hidden)[:, 0] if compute_logits else None
        return logits, hidden[:, 0], caches

    def decode_chunk(self, token_embeds, position_ids, caches, cache_len):
        """Cached decode of n tokens with no sequential data dependence (the
        traj-latent queries): equal to n `decode_step` calls, one weight
        pass. Returns (hidden (B, n, E), caches)."""
        return self._decode(token_embeds, position_ids, caches, cache_len), caches


def _layer_hidden(layer, x, cos, sin, segment_ids, tile_tables):
    """A decoder layer's hidden output alone (the checkpointed function)."""
    return layer(x, cos, sin, segment_ids=segment_ids, tile_tables=tile_tables)[0]


def pad_caches(caches: List[KVCache], max_len: int) -> List[KVCache]:
    """Extend prefill caches (B, T, KV, D) to (B, max_len, KV, D)."""
    def pad(e):
        return F.pad(e, (0, 0, 0, 0, 0, max_len - e.shape[1]))

    return [(pad(k), pad(v)) for k, v in caches]


@torch.no_grad()
def greedy_generate(model: QwenTextModel, inputs_embeds, position_ids, *,
                    rope_deltas, prompt_lengths, segment_ids,
                    max_new_tokens: int = 128,
                    eos_token_ids: Tuple[int, ...] = (151645,),
                    extra_cache_slots: int = 0):
    """Greedy decoding: prefill, then one cached step per token until every
    row has emitted a stop token or the budget is spent.

    Returns (tokens (B, max_new_tokens) EOS-padded, lengths (B,), caches
    holding the prompt's and the generated tokens' K/V, with
    `extra_cache_slots` free slots after them).
    The prompt is right-padded to a bucket: `prompt_lengths` (B,) are the
    real lengths and `segment_ids` put the pads in their own segment, so
    decoding starts from the last real token and new tokens overwrite the
    pad cache slots — the result equals the unpadded run. rope_deltas (B,)
    is the M-RoPE decode offset (position = length + delta + step)."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    prompt_lengths = prompt_lengths.long()
    rope_deltas = rope_deltas.long()

    logits, _, caches = model(inputs_embeds, position_ids, segment_ids=segment_ids,
                              logits_indices=prompt_lengths - 1)
    caches = pad_caches(caches, T + max_new_tokens + extra_cache_slots)
    eos = torch.as_tensor(eos_token_ids, device=dev)
    tokens = torch.full((B, max_new_tokens), int(eos_token_ids[0]), dtype=torch.long, device=dev)
    tokens[:, 0] = logits[:, 0].argmax(-1)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    step = 0
    all_done = False
    while step < max_new_tokens and not all_done:
        cur = tokens[:, step]
        done = done | torch.isin(cur, eos)
        all_done = bool(done.all())
        pos = (prompt_lengths + rope_deltas + step)[None, :, None].expand(3, B, 1)
        _, hidden, caches = model.decode_step(model.embed(cur[:, None]), pos, caches,
                                              prompt_lengths + step, compute_logits=False)
        # the last step only writes the final token's K/V (the traj-latent
        # chunk reads it); its logits would be discarded
        if step + 1 < max_new_tokens and not all_done:
            nxt = model._logits(hidden).argmax(-1)
            tokens[:, step + 1] = torch.where(done, eos[0], nxt)
        step += 1
    is_eos = torch.isin(tokens, eos)
    lengths = torch.where(is_eos.any(1), is_eos.int().argmax(1),
                          torch.full_like(prompt_lengths, max_new_tokens))
    return tokens, lengths, caches
