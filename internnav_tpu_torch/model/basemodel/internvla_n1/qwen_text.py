"""Qwen2.5 text decoder — the InternVLA-N1 System-2 LLM.

Port of internnav_tpu/model/basemodel/internvla_n1/qwen_text.py:
RMSNorm, SwiGLU MLP (XLA's bf16 SiLU, `ops/activations.py`), GQA attention
with q/k/v biases, M-RoPE, the LM head (or tied embeddings), cached greedy
decode with the rope-delta fast path, the chunked decode of the
traj-latent queries, and for training the per-layer
rematerialization (`QwenTextConfig.remat`) and the chunked full-vocab
cross-entropy (`chunked_ce`).

- Prefill runs `flash_attention` (the Hopper kernel on CUDA) with causal +
  pad-isolating segment ids, on UN-repeated K/V: query head h reads KV head
  h // (H // KV) inside the kernel. The segment ids' tile tables are built
  once per forward and shared by every layer (and their backward).
- Decode writes the new K/V into the preallocated cache IN PLACE (the JAX
  package returns updated copies); the cache is owned by the decode loop.
- The quantized formats: `weight_dtype="int8"` makes every projection
  (q/k/v/o, gate/up/down, lm_head; never the embedding) a `QuantLinear`,
  the port of `QuantDense` at 8 bits (W8A8: activations quantized per
  token by K6a, the product by K6b: at decode rows the projections of one
  input, q/k/v and gate/up, in one launch). `weight_dtype="int4"` (W4A8)
  stores the layers' projections as packed int4 codes with grouped-128
  scales (per channel where 128 does not divide the input width), their
  products by K9, and keeps the lm_head at 8 bits with grouped-128 scales
  (K6b; JAX `_wbits_for`, `_effective_group`). With
  `decode_act_dtype="bf16"` (W8A16 / W4A16) the projections of a step that
  reads a cache (`decode_step`, `decode_chunk` and their grouped forms)
  take bf16 activations, unquantized, through K10, the lm_head at decode
  too; such a layer runs the plain RMSNorm and `silu_mul` (K8), and no
  K6a. The prefill keeps W8A8 / W4A8. K6a
  quantizes inside the op that makes its input: the decoder layer's two
  RMSNorms (the second with the residual add before it) and the SwiGLU
  product, so those layers call neither `RMSNorm` nor `silu_mul`; o_proj's
  and the lm_head's inputs are quantized as they are. `kv_dtype="int8"` makes
  each cache entry an (int8 data, fp32 scale) tuple, read by the int8
  decode attention K4/K5; a decode step or chunk rotates q and k,
  quantizes K/V and writes the cache in one K7 launch (`rope_kv_write`),
  with no `apply_rotary`. The prompt's attention runs over bf16 K/V
  (rotated by `apply_rotary`); only the stored cache is int8, written by
  K7 without rotary (`ops/quant.py`, `ops/flash_attention.py`).
- The grouped decode (`decode_step_grouped`, `decode_chunk_grouped`,
  `greedy_decode_grouped`) serves several prefill cohorts' caches with one
  pass over the weights: the projections run once over the stacked rows,
  the rotary, cache write and attention once per group on its own cache.
- `greedy_generate` and `greedy_decode_grouped` drive their loop through
  `decode_graph.DecodeLoop`: static caches the prefill writes into, and
  on CUDA one captured CUDA graph per decode step, replayed in chunks.
- Tensor-parallel training (`parallel/tp.py`) splits q/k/v and gate/up by
  output columns, o and down by input columns, the embedding and the
  lm_head by vocab rows. The attention takes its head counts from the
  local q/k widths (K1-K3 see whole local heads, the GQA ratio kept), and
  `ce_sum` reduces a vocab-split cross-entropy over the group.
- Tensor-parallel serving (`parallel/tp.apply_serve_tp`) holds the same
  splits as plain local tensors: the attention and the MLP all-reduce
  o_proj's and down_proj's partial sums over the model's `tp_group`, the
  embedding looks up its vocab rows and all-reduces, and `greedy_token`
  takes the argmax over the vocab-split lm_head across the group, ties to
  the lowest id as `jnp.argmax`. The config's head counts are the rank's,
  so the static caches hold its KV heads. Where ranks share a KV head (tp
  = 8 at 7B) a rank's heads are (4, 1) or (3, 1): every local query head
  reads the one local KV head, and o_proj's input blocks are uneven.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from internnav_tpu_torch.ops.activations import silu_mul
from internnav_tpu_torch.ops.flash_attention import (
    flash_attention,
    gqa_chunk_decode_attention,
    gqa_decode_attention,
    segment_tile_tables,
)
from internnav_tpu_torch.ops.quant import (
    QMAX,
    cache_write_slots,
    div_qmax,
    effective_group,
    grouped_scales,
    pack_int4,
    quantize_activations,
    rms_norm,
    rmsnorm_quantize,
    rope_kv_write,
    store_cache_rows_,
    swiglu_quantize,
    w4a8_linear_multi,
    w8a8_linear_multi,
    w8a16_linear_multi,
    write_kv_cache,
)
from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import (
    DecodeBuffers,
    DecodeLoop,
    StaticCaches,
)
from internnav_tpu_torch.ops.rope import apply_rotary, mrope_cos_sin, rope_cos_sin
from internnav_tpu_torch.parallel.collectives import (
    all_reduce_sum_,
    pmax,
    psum_forward,
    vocab_argmax,
)

#: a cache entry: bf16 (B, T, KV, D), or (int8 (B, T, KV, D), fp32 scale
#: (B, T, KV, 1)) with kv_dtype="int8"
CacheEntry = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
KVCache = Tuple[CacheEntry, CacheEntry]


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
    #: no lm_head: the logits are the fp32 product of the final hidden
    #: state and the embedding table (a checkpoint without lm_head.weight)
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    #: projection weights: "bf16" (nn.Linear), "int8" (`QuantLinear`,
    #: W8A8) or "int4" (W4A8: packed int4 codes, grouped-128 scales by
    #: default, the lm_head kept at 8 bits)
    weight_dtype: str = "bf16"
    #: scale granularity: None per output channel (int4: 128); g per (g
    #: inputs x output channel) where g divides the input width, else per
    #: channel
    quant_group_size: Optional[int] = None
    #: cached-decode activations with quantized weights: "int8" (W8A8 /
    #: W4A8, as the prefill) or "bf16" (W8A16 / W4A16: bf16 activations
    #: times the widened codes, K10)
    decode_act_dtype: str = "int8"
    #: KV cache storage: "bf16", or "int8" with one fp32 scale per (token,
    #: KV head)
    kv_dtype: str = "bf16"
    #: recompute each decoder layer in backward (torch.utils.checkpoint)
    #: instead of keeping its activations; the parameter names are unchanged
    remat: bool = False

    def __post_init__(self):
        if self.weight_dtype not in ("bf16", "int8", "int4"):
            raise ValueError(f"unknown weight_dtype {self.weight_dtype!r}")
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")
        if self.decode_act_dtype not in ("int8", "bf16"):
            raise ValueError(f"unknown decode_act_dtype {self.decode_act_dtype!r}")

    @property
    def decode_bf16_act(self) -> bool:
        """W8A16 / W4A16 decode: quantized weights with
        decode_act_dtype="bf16" (JAX `_decode_bf16_act`)."""
        return self.weight_dtype in ("int8", "int4") and self.decode_act_dtype == "bf16"

    @classmethod
    def tiny(cls) -> "QwenTextConfig":
        """Test-size config (structure-identical)."""
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=16, mrope_section=(2, 3, 3))


class RMSNorm(nn.Module):
    """The JAX package's RMSNorm: an fp32 scale, and the product of the
    normalised input (rounded to the input's dtype) and that scale in fp32.
    A bf16 consumer casts the product once to its dtype (`project`), as a
    flax Dense does with an fp32 input; the W8A8 projections quantize the
    fp32 rows."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def _wbits_for(name: str, weight_bits: int) -> int:
    """The W4A8 rule of the JAX package (`_wbits_for`): the lm_head stays
    at 8 bits under int4."""
    return 8 if weight_bits == 4 and name == "lm_head" else weight_bits


def quantize_weight(w: torch.Tensor, group_size: Optional[int] = None, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric weight quantization of a torch-layout (N, K) weight, on
    its device, to `bits` (8: codes in [-127, 127] as int8 (N, K); 4: codes
    in [-7, 7] packed two a byte, `pack_int4`, uint8 (N, K / 2)): per output
    channel, scale (N,) = max|w| / qmax over K; or, when group_size divides
    K, per (group, channel), scale (K / g, N). A zero scale becomes 1e-8.
    The math of `quantize_qwen_text_params`; the caller picks the group
    (`effective_group`)."""
    w32 = w.float()
    N, K = w32.shape
    qmax = QMAX[bits]
    g = grouped_scales(K, group_size)
    if g:
        wg = w32.view(N, K // g, g)
        s = div_qmax(wg.abs().amax(-1), bits)
        s = torch.where(s == 0, 1e-8, s)
        q = torch.round(wg / s[..., None]).clamp(-qmax, qmax).view(N, K)
        s = s.T.contiguous()
    else:
        s = div_qmax(w32.abs().amax(1), bits)
        s = torch.where(s == 0, 1e-8, s)
        q = torch.round(w32 / s[:, None]).clamp(-qmax, qmax)
    q = q.to(torch.int8)
    return (pack_int4(q) if bits == 4 else q), s


class QuantLinear(nn.Module):
    """Port of `QuantDense`: buffers `weight_q`, `scale_q` (N,) or grouped
    (K / g, N) fp32 and an optional fp32 `bias`; w ≈ codes * scale. At
    weight_bits=8 `weight_q` is int8 (N, K); at 4 it holds codes in [-7, 7]
    packed two a byte along K (`pack_int4`), uint8 (N, K / 2). The input is
    quantized per token (`quantize_activations`) and multiplied in int8
    with int32 sums (W8A8 `w8a8_linear_multi`, W4A8 `w4a8_linear_multi`),
    or at decode under decode_act_dtype="bf16" taken as bf16
    (`w8a16_linear_multi`), through `project`; the output has the module's dtype. The weight is
    stored (N, K), K contiguous: the layout int8 tensor-core products take
    for their B operand."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 group_size: Optional[int] = None, dtype: torch.dtype = torch.bfloat16,
                 weight_bits: int = 8):
        super().__init__()
        if weight_bits not in QMAX or (weight_bits == 4 and in_features % 2):
            raise ValueError(f"QuantLinear: {weight_bits}-bit weights of {in_features} inputs")
        self.in_features, self.out_features, self.dtype = in_features, out_features, dtype
        self.group_size, self.weight_bits = group_size, weight_bits
        g = grouped_scales(in_features, group_size)
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features // 2) if weight_bits == 4 else (out_features, in_features),
            dtype=torch.uint8 if weight_bits == 4 else torch.int8))
        self.register_buffer("scale_q", torch.ones(
            (in_features // g, out_features) if g else (out_features,), dtype=torch.float32))
        self.register_buffer("bias", torch.zeros(out_features, dtype=torch.float32)
                             if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear, group_size: Optional[int] = None,
                    weight_bits: int = 8) -> "QuantLinear":
        """The quantized copy of a Linear, on its device."""
        with torch.device(lin.weight.device):
            out = cls(lin.in_features, lin.out_features, lin.bias is not None, group_size,
                      dtype=lin.weight.dtype, weight_bits=weight_bits)
        out.weight_q, out.scale_q = quantize_weight(lin.weight, group_size, weight_bits)
        if lin.bias is not None:
            out.bias = lin.bias.detach().float()
        return out

    @torch.no_grad()
    def load_weight_(self, w: torch.Tensor) -> None:
        """Set weight_q / scale_q to the quantization of the (N, K) weight
        w (any device and float dtype; cast to the module's dtype first, as
        the bf16 weights of a random build are), streamed through the
        module's device a block of rows at a time: every row's scales and
        codes depend on that row alone, so this equals `quantize_weight` of
        the whole matrix, bit for bit, without its fp32 copy."""
        N, K = w.shape
        if (N, K) != (self.out_features, self.in_features):
            raise ValueError(f"weight {tuple(w.shape)} for a QuantLinear of "
                             f"{(self.out_features, self.in_features)}")
        step = max(1, 2**25 // K)
        for r in range(0, N, step):
            rows = w[r:r + step].to(self.weight_q.device, self.dtype)
            q, s = quantize_weight(rows, self.group_size, self.weight_bits)
            self.weight_q[r:r + step] = q
            self.scale_q[..., r:r + step] = s

    def forward(self, x):
        return project(x, self)[0]


class QuantizedRows(NamedTuple):
    """An input already quantized for `QuantLinear`s (by the op that made
    it: `rmsnorm_quantize`, `swiglu_quantize`): int8 codes (..., K) and
    fp32 scales (..., 1)."""
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape


def project(x: Union[torch.Tensor, QuantizedRows], *mods: nn.Module,
            bf16_act: bool = False) -> List[torch.Tensor]:
    """Each projection of one input, in one call for all of them. An
    nn.Linear takes the input cast to its dtype (once, for all of them).
    `QuantLinear`s with bf16_act (W8A16 / W4A16) take it cast to bf16,
    unquantized (`w8a16_linear_multi`: one K10 launch on CUDA). Otherwise
    the input, bf16 or fp32, is quantized once and shared (q/k/v, gate/up),
    or comes quantized as `QuantizedRows`: the quantization is a function
    of the input alone, so this equals the JAX package's quantization
    inside every projection. 8-bit products go to `w8a8_linear_multi`, 4-bit
    ones to `w4a8_linear_multi`: on CUDA one K6b or K9 launch for all of
    them at decode rows (M <= 16), one prefill launch a projection above.
    So a decode layer pass launches 4 GEMMs (q/k/v and gate/up fused, o,
    down) in every format; an int8 or int4 prefill layer pass 7."""
    if not isinstance(mods[0], QuantLinear):
        x = x.to(mods[0].weight.dtype)
        return [m(x) for m in mods]
    bits = {m.weight_bits for m in mods}
    if len(bits) != 1:
        raise ValueError(f"project: one input's projections mix weight widths {sorted(bits)}")
    segments = [(m.weight_q, m.scale_q, m.bias) for m in mods]
    if bf16_act:
        if isinstance(x, QuantizedRows):
            raise ValueError("project: W8A16 takes the bf16 rows, not their quantized codes")
        lead, K = x.shape[:-1], x.shape[-1]
        outs = w8a16_linear_multi(x.reshape(-1, K).to(torch.bfloat16), segments,
                                  out_dtype=mods[0].dtype)
    else:
        if not isinstance(x, QuantizedRows):
            x = QuantizedRows(*quantize_activations(x))
        lead, K = x.shape[:-1], x.shape[-1]
        xq, a_scale = x.q.reshape(-1, K), x.scale.reshape(-1, 1)
        linear = w4a8_linear_multi if bits == {4} else w8a8_linear_multi
        outs = linear(xq, a_scale, segments, out_dtype=mods[0].dtype)
    return [y.reshape(*lead, m.out_features) for y, m in zip(outs, mods)]


def _proj(cfg: QwenTextConfig, in_features: int, out_features: int, bias: bool,
          name: str) -> nn.Module:
    """nn.Linear, or a QuantLinear with weight_dtype "int8" or "int4" (the
    JAX `_proj`: under int4 every projection takes `effective_group`'s
    scales, and `name` "lm_head" stays at 8 bits)."""
    if cfg.weight_dtype == "int4":
        return QuantLinear(in_features, out_features, bias,
                           effective_group(cfg.quant_group_size, 4), cfg.dtype,
                           weight_bits=_wbits_for(name, 4))
    if cfg.weight_dtype == "int8":
        return QuantLinear(in_features, out_features, bias, cfg.quant_group_size, cfg.dtype)
    return nn.Linear(in_features, out_features, bias=bias, dtype=cfg.dtype)


class QwenAttention(nn.Module):
    #: the serving layout's tp group when o_proj holds a block of its input
    #: columns: its partial sums are all-reduced over it
    tp_group = None

    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        self.cfg = cfg
        H, KV, D, E = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim, cfg.hidden_size)
        self.q_proj = _proj(cfg, E, H * D, True, "q_proj")
        self.k_proj = _proj(cfg, E, KV * D, True, "k_proj")
        self.v_proj = _proj(cfg, E, KV * D, True, "v_proj")
        self.o_proj = _proj(cfg, H * D, E, False, "o_proj")

    def forward(self, x, cos, sin, *, segment_ids=None, tile_tables=None,
                kv_cache: Optional[KVCache] = None, cache_len=None, cache_out=None,
                cache_groups: Optional[Sequence[KVCache]] = None, cache_len_groups=None,
                bf16_act: bool = False):
        """Prefill when kv_cache and cache_groups are None: returns (out,
        (k, v)) with the new cache entries (B, T, KV, D), or, given
        `cache_out` (entries of a longer cache, `StaticCaches`), with the
        prompt's K/V written into its first T slots and cache_out returned;
        tile_tables are `segment_tile_tables` of segment_ids (built by the
        kernel wrapper when None). Otherwise x holds n >= 1 new tokens
        whose K/V are written into kv_cache at cache_len (B,) in place, each
        attending stepwise-causally over the cache. With cache_groups (a
        list of per-group caches) and cache_len_groups (their (B_g,)
        lengths), x stacks the groups' rows: the projections run once over
        the stack and the rest per group on its own cache, row for row
        what a call per group gives. x is the normed input, or with W8A8 /
        W4A8 projections its `QuantizedRows`; bf16_act (a cached step under
        decode_act_dtype="bf16") runs every projection W8A16 on the normed
        input. With kv_dtype="int8" the prefill
        attends over the rotated bf16 K/V and writes their quantized
        entries; decode rotates, quantizes and writes in one K7 launch
        (`rope_kv_write`) and attends through K4/K5 on strided views of the
        cache."""
        c = self.cfg
        B, n = x.shape[:2]
        q, k, v = project(x, self.q_proj, self.k_proj, self.v_proj, bf16_act=bf16_act)
        # the heads this rank holds: all of them, or a tensor-parallel
        # rank's column block of q/k/v (whole heads, the GQA ratio kept)
        D = c.head_dim
        H, KV = q.shape[-1] // D, k.shape[-1] // D
        if kv_cache is not None:
            cache_groups, cache_len_groups = [kv_cache], [cache_len]
        if cache_groups is not None:
            outs, r = [], 0
            for cache, cl in zip(cache_groups, cache_len_groups):
                rows = slice(r, r + cl.shape[0])
                outs.append(self._cached_attention(q[rows], k[rows], v[rows], cos[rows],
                                                   sin[rows], cache, cl))
                r += cl.shape[0]
            out = outs[0] if len(outs) == 1 else torch.cat(outs)
            out = project(out.transpose(1, 2).reshape(B, n, H * D), self.o_proj,
                          bf16_act=bf16_act)[0]
            return all_reduce_sum_(out, self.tp_group), (
                kv_cache if kv_cache is not None else cache_groups)
        q = q.reshape(B, n, H, D).transpose(1, 2)
        k = k.reshape(B, n, KV, D).transpose(1, 2)
        v = v.reshape(B, n, KV, D)
        q, k = apply_rotary(q, k, cos, sin)
        out = flash_attention(q.contiguous(), k.contiguous(), v.transpose(1, 2).contiguous(),
                              causal=True, segment_ids=segment_ids, tile_tables=tile_tables)
        k = k.transpose(1, 2)
        if cache_out is not None:
            if c.kv_dtype == "int8":
                write_kv_cache(k.contiguous(), v.contiguous(), *cache_out,
                               torch.zeros(B, dtype=torch.long, device=k.device))
            else:
                cache_out[0][:, :n].copy_(k)
                cache_out[1][:, :n].copy_(v)
            new_cache = cache_out
        elif c.kv_dtype == "int8":
            new_cache = _int8_entries(k, v)
        else:
            new_cache = (k, v)
        out = out.transpose(1, 2).reshape(B, n, H * D)
        return all_reduce_sum_(self.o_proj(out), self.tp_group), new_cache

    def _cached_attention(self, q, k, v, cos, sin, cache: KVCache, cache_len):
        """Attention of one cache group: q (B, n, H D), k/v (B, n, KV D)
        projected rows, cos/sin (B, n, D); their K/V written into the cache
        at cache_len (B,) in place. Returns (B, H, n, D)."""
        D = self.cfg.head_dim
        B, n = q.shape[:2]
        H, KV = q.shape[-1] // D, k.shape[-1] // D
        k_cache, v_cache = cache
        if isinstance(k_cache, tuple):
            q = rope_kv_write(q, k, v, cos, sin, k_cache, v_cache, cache_len)
            return self._decode_attention(q, k_cache, v_cache, cache_len)
        q, k = apply_rotary(q.reshape(B, n, H, D).transpose(1, 2),
                            k.reshape(B, n, KV, D).transpose(1, 2), cos, sin)
        cols, keep = cache_write_slots(cache_len, n, k_cache.shape[1])
        store_cache_rows_(k_cache, k.transpose(1, 2), cols, keep)
        store_cache_rows_(v_cache, v.reshape(B, n, KV, D), cols, keep)
        return self._decode_attention(q, k_cache, v_cache, cache_len)

    @staticmethod
    def _decode_attention(q, k_cache: CacheEntry, v_cache: CacheEntry, cache_len):
        """q (B, H, n, D) over the cache written up to cache_len + n: one
        token (K4 on an int8 cache) or a stepwise-causal chunk (K5)."""
        n = q.shape[2]
        (kd, ks), (vd, vs) = _cache_kvtd(k_cache), _cache_kvtd(v_cache)
        if n == 1:
            return gqa_decode_attention(q[:, :, 0], kd, vd, cache_len + 1,
                                        k_scale=ks, v_scale=vs)[:, :, None]
        return gqa_chunk_decode_attention(q, kd, vd, cache_len, k_scale=ks, v_scale=vs)


def _int8_entries(k: torch.Tensor, v: torch.Tensor) -> KVCache:
    """Quantized cache entries of k/v (B, T, KV, D): written into new
    (int8 data, fp32 scale) buffers at position 0 by `write_kv_cache`."""
    B, T, KV, D = k.shape

    def entry():
        return (torch.empty((B, T, KV, D), dtype=torch.int8, device=k.device),
                torch.empty((B, T, KV, 1), dtype=torch.float32, device=k.device))

    k_entry, v_entry = entry(), entry()
    write_kv_cache(k.contiguous(), v.contiguous(), k_entry, v_entry,
                   torch.zeros(B, dtype=torch.long, device=k.device))
    return k_entry, v_entry


def _cache_kvtd(entry: CacheEntry):
    """A cache entry as the decode attention reads it: ((B, KV, Tmax, D)
    data, (B, KV, Tmax) scale or None), both strided views, no copy."""
    if isinstance(entry, tuple):
        data, scale = entry
        return data.transpose(1, 2), scale[..., 0].transpose(1, 2)
    return entry.transpose(1, 2), None


class QwenMLP(nn.Module):
    #: the serving layout's tp group when down_proj holds a block of its
    #: input columns
    tp_group = None

    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        E, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _proj(cfg, E, I, False, "gate_proj")
        self.up_proj = _proj(cfg, E, I, False, "up_proj")
        self.down_proj = _proj(cfg, I, E, False, "down_proj")

    def forward(self, x, bf16_act: bool = False):
        """x: the normed input, or with W8A8 / W4A8 projections its
        `QuantizedRows`; then the SwiGLU product is quantized as it is made
        (K6a). With bf16_act (W8A16 / W4A16) the product is the bf16
        `silu_mul` (K8), taken as it is by down_proj."""
        gate, up = project(x, self.gate_proj, self.up_proj, bf16_act=bf16_act)
        if isinstance(self.down_proj, QuantLinear) and not bf16_act:
            out = project(QuantizedRows(*swiglu_quantize(gate, up)), self.down_proj)[0]
        else:
            out = project(silu_mul(gate, up), self.down_proj, bf16_act=bf16_act)[0]
        return all_reduce_sum_(out, self.tp_group)


class QwenDecoderLayer(nn.Module):
    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = QwenAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = QwenMLP(cfg)

    def forward(self, x, cos, sin, *, segment_ids=None, tile_tables=None, kv_cache=None,
                cache_len=None, cache_out=None, cache_groups=None, cache_len_groups=None):
        kw = dict(segment_ids=segment_ids, tile_tables=tile_tables, kv_cache=kv_cache,
                  cache_len=cache_len, cache_out=cache_out, cache_groups=cache_groups,
                  cache_len_groups=cache_len_groups)
        norm1, norm2 = self.input_layernorm, self.post_attention_layernorm
        # W8A16 / W4A16 exactly where a cache is read (JAX `decoding`)
        bf16_act = (kv_cache is not None or cache_groups is not None) \
            and self.self_attn.cfg.decode_bf16_act
        if bf16_act or not isinstance(self.mlp.down_proj, QuantLinear):
            h, new_cache = self.self_attn(norm1(x), cos, sin, bf16_act=bf16_act, **kw)
            x = x + h
            return x + self.mlp(norm2(x), bf16_act=bf16_act), new_cache
        # W8A8 / W4A8: each norm quantizes the rows it makes (K6a), the
        # second after adding the attention output to the residual stream
        xq, scale, _ = rmsnorm_quantize(x, norm1.weight, norm1.eps)
        h, new_cache = self.self_attn(QuantizedRows(xq, scale), cos, sin, **kw)
        xq, scale, x = rmsnorm_quantize(h, norm2.weight, norm2.eps, residual=x)
        return x + self.mlp(QuantizedRows(xq, scale)), new_cache


class QwenTextModel(nn.Module):
    """Decoder trunk. forward = prefill; `decode_step` / `decode_chunk` =
    cached decode."""

    #: the serving layout (`parallel/tp.apply_serve_tp`): its tp group, and
    #: the first vocab id of this rank's embedding rows and lm_head rows
    #: where those are split; None when the model is whole
    tp_group = None
    embed_start: Optional[int] = None
    head_start: Optional[int] = None

    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype)
        self.layers = nn.ModuleList(QwenDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else _proj(cfg, cfg.hidden_size, cfg.vocab_size, False, "lm_head"))

    def embed(self, input_ids):
        ids = input_ids.long()
        if self.embed_start is None:
            return self.embed_tokens(ids)
        # this rank's vocab rows; the other ranks' ids look up exact zeros
        local = ids - self.embed_start
        mine = (local >= 0) & (local < self.embed_tokens.num_embeddings)
        rows = self.embed_tokens(torch.where(mine, local, 0))
        return all_reduce_sum_(torch.where(mine[..., None], rows, 0), self.tp_group)

    def greedy_token(self, logits):
        """The greedy next token of logits (..., vocab): the argmax over the
        whole vocab, the lowest id among ties (`jnp.argmax`). Under the
        serving layout logits holds this rank's vocab columns (`_logits` of
        a split lm_head), and the argmax runs across the tp group."""
        if self.head_start is None:
            return logits.argmax(-1)
        return vocab_argmax(logits, self.head_start, self.tp_group)

    def _cos_sin(self, position_ids):
        """Rotary tables: M-RoPE for (3, B, T) t/h/w position ids, 1-D RoPE
        for (B, T) ones (JAX `_cos_sin`)."""
        c = self.cfg
        if position_ids.dim() == 3:
            return mrope_cos_sin(position_ids, c.head_dim, c.mrope_section, c.rope_theta)
        return rope_cos_sin(position_ids, c.head_dim, c.rope_theta)

    def forward(self, inputs_embeds, position_ids, *, segment_ids=None, logits_indices=None,
                compute_logits: bool = True, caches_out: Optional[List[KVCache]] = None):
        """Prefill. inputs_embeds (B, T, E); position_ids (3, B, T) or (B, T).
        Returns (logits, hidden, caches): hidden (B, T, E) is the final
        norm's fp32 product, caches per layer (k, v) of (B, T, KV, D), or
        `caches_out` (per-layer entries of (B, Tmax >= T, KV, D) static
        caches) with the prompt's K/V written into their first T slots;
        logits_indices (B,) computes the logits only at those
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
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(_layer_hidden, layer, x, cos, sin, segment_ids, tile_tables,
                               use_reentrant=False)
            else:
                x, cache = layer(x, cos, sin, segment_ids=segment_ids, tile_tables=tile_tables,
                                 cache_out=None if caches_out is None else caches_out[i])
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

    def _logits(self, hidden, *, decode: bool = False):
        """fp32 logits of the final norm's rows (this rank's vocab columns
        under the serving layout); at a decode step (`decode`) under
        decode_act_dtype="bf16" the lm_head runs W8A16 (K10)."""
        if self.lm_head is None:  # tied: never quantized, as in the JAX package
            return hidden.float() @ self.embed_tokens.weight.float().T
        return project(hidden, self.lm_head,
                       bf16_act=decode and self.cfg.decode_bf16_act)[0].float()

    def chunked_ce(self, hidden, labels, *, ignore_index: int, chunk: int = 1024):
        """Mean next-token cross-entropy over the full vocab without the
        (B, T, vocab) fp32 logits: the lm_head and the softmax-CE run per
        `chunk` positions under checkpoint, so one chunk's logits are live
        at a time and backward recomputes them. Same value as the
        full-logits loss on shifted logits / labels."""
        tot, cnt = self.chunked_ce_sum(hidden, labels, ignore_index=ignore_index, chunk=chunk)
        return tot / cnt.clamp(min=1.0)

    def chunked_ce_sum(self, hidden, labels, *, ignore_index: int, chunk: int = 1024):
        """`chunked_ce` as (sum of the CE, count of the valid labels), both
        fp32 0-d: a trainer that splits a batch across micro-batches or
        ranks divides the sums by the count over all of them."""
        h = hidden[:, :-1]
        lbl = labels[:, 1:]
        tot = hidden.new_zeros((), dtype=torch.float32)
        cnt = hidden.new_zeros((), dtype=torch.float32)
        for start in range(0, h.shape[1], chunk):
            t, c = checkpoint(self._chunk_ce, h[:, start:start + chunk],
                              lbl[:, start:start + chunk], ignore_index, use_reentrant=False)
            tot = tot + t
            cnt = cnt + c
        return tot, cnt

    def _chunk_ce(self, h, lbl, ignore_index: int):
        """(sum of CE, count) over the valid labels of one chunk."""
        return self.ce_sum(self._logits(h), lbl, ignore_index)

    def ce_sum(self, logits, lbl, ignore_index: int):
        """(sum of CE, count) over the valid labels: fp32 logits (..., V)
        against labels (...). When the lm_head is split over the vocab
        (tensor parallel, a DTensor weight), logits holds this rank's
        vocab columns: the log-sum-exp and the target logit are summed
        over the group, and every rank of it returns the same values."""
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0).long()
        shard = self._vocab_shard()
        if shard is None:
            gold = logits.gather(-1, safe[..., None])[..., 0]
            ce = torch.logsumexp(logits, dim=-1) - gold
            return (ce * valid).sum(), valid.sum().float()
        group, start = shard
        v_local = logits.shape[-1]
        m = pmax(logits.detach().amax(-1), group)
        lse = psum_forward((logits - m[..., None]).exp_().sum(-1), group).log() + m
        local = (safe >= start) & (safe < start + v_local)
        picked = logits.gather(-1, torch.where(local, safe - start, 0)[..., None])[..., 0]
        gold = psum_forward(torch.where(local, picked, 0.0), group)
        ce = lse - gold
        return (ce * valid).sum(), valid.sum().float()

    def _vocab_shard(self):
        """(process group, first vocab id) of this rank's lm_head columns
        when the lm_head is tensor-parallel, else None. Inside a forward,
        FSDP's gathered parameters are plain tensors; a DTensor weight here
        is a tensor-parallel split of the vocab rows."""
        w = None if self.lm_head is None else getattr(self.lm_head, "weight", None)
        if w is None or not hasattr(w, "device_mesh"):
            return None
        mesh = w.device_mesh
        return mesh.get_group(), mesh.get_local_rank() * w.to_local().shape[0]

    def _decode_grouped(self, token_embeds, position_ids, cache_trees, cache_lens):
        cos, sin = self._cos_sin(position_ids)
        x = token_embeds
        for li, layer in enumerate(self.layers):
            x, _ = layer(x, cos, sin, cache_groups=[t[li] for t in cache_trees],
                         cache_len_groups=cache_lens)
        return self.norm(x)

    def decode_step(self, token_embeds, position_ids, caches, cache_len,
                    compute_logits: bool = True):
        """One cached decode step: token_embeds (B, 1, E); cache_len (B,) is
        where the new token goes. Returns (logits (B, vocab) or None,
        hidden (B, E) fp32, caches) — the caches are updated in place."""
        hidden = self._decode_grouped(token_embeds, position_ids, [caches], [cache_len])
        logits = self._logits(hidden, decode=True)[:, 0] if compute_logits else None
        return logits, hidden[:, 0], caches

    def decode_chunk(self, token_embeds, position_ids, caches, cache_len):
        """Cached decode of n tokens with no sequential data dependence (the
        traj-latent queries): equal to n `decode_step` calls, one weight
        pass. Returns (hidden (B, n, E) fp32, caches)."""
        return self._decode_grouped(token_embeds, position_ids, [caches], [cache_len]), caches

    def decode_step_grouped(self, token_embeds, position_ids, cache_trees, cache_lens,
                            compute_logits: bool = True):
        """Grouped cached decode: one pass over the weights serves several
        cache groups (serving cohorts). token_embeds (B_total, 1, E) stacks
        the groups' rows in order; cache_trees is a list of per-group caches
        (each a list of per-layer (k, v)), cache_lens a list of (B_g,).
        Row for row what `decode_step` gives per group; the caches are
        updated in place. Returns (logits or None, hidden (B_total, E),
        cache_trees)."""
        hidden = self._decode_grouped(token_embeds, position_ids, cache_trees, cache_lens)
        logits = self._logits(hidden, decode=True)[:, 0] if compute_logits else None
        return logits, hidden[:, 0], cache_trees

    def decode_chunk_grouped(self, token_embeds, position_ids, cache_trees, cache_lens):
        """Grouped `decode_chunk`: n chunk tokens a row, one pass over the
        weights for every group. Returns (hidden (B_total, n, E),
        cache_trees)."""
        return self._decode_grouped(token_embeds, position_ids, cache_trees, cache_lens), \
            cache_trees


def _layer_hidden(layer, x, cos, sin, segment_ids, tile_tables):
    """A decoder layer's hidden output alone (the checkpointed function)."""
    return layer(x, cos, sin, segment_ids=segment_ids, tile_tables=tile_tables)[0]


def pad_caches(caches: List[KVCache], max_len: int) -> List[KVCache]:
    """Extend prefill caches (B, T, KV, D) to (B, max_len, KV, D) with
    zeros; an int8 entry pads its data and its scales."""
    def pad(e):
        if isinstance(e, tuple):
            return tuple(pad(x) for x in e)
        return F.pad(e, (0, 0, 0, 0, 0, max_len - e.shape[1]))

    return [(pad(k), pad(v)) for k, v in caches]


def quantize_qwen_text_params(params: Dict, group_size: Optional[int] = None,
                              weight_bits: int = 8) -> Dict:
    """A JAX-layout QwenTextModel param tree (nested dicts of numpy
    arrays, Dense kernels (in, out)) → its quantized tree: every Dense
    `kernel` but the embedding's becomes `kernel_q` (in, out) codes + `scale_q`
    fp32, (out,) per channel or (in / g, out) when the group divides the
    input width; biases, norms and embeddings pass through. weight_bits=4
    gives codes in [-7, 7] with grouped-128 scales by default
    (`effective_group`) and keeps the lm_head at 8 bits with the same
    groups (`_wbits_for`). Codes are int8 numpy arrays at either width (the
    JAX package stores int4 leaves as jnp.int4; `from_jax` packs them).
    The port's own copy of the JAX package's `quantize_qwen_text_params`."""
    group_size = effective_group(group_size, weight_bits)

    def quantize(w, bits):
        qmax = float(QMAX[bits])
        if group_size and w.shape[0] % int(group_size) == 0:
            K, N = w.shape
            wg = w.reshape(K // int(group_size), int(group_size), N)
            s = np.abs(wg).max(axis=1) / qmax
            s = np.where(s == 0, 1e-8, s)
            q = np.clip(np.round(wg / s[:, None]), -qmax, qmax).reshape(K, N)
        else:
            s = np.abs(w).max(axis=0) / qmax
            s = np.where(s == 0, 1e-8, s)
            q = np.clip(np.round(w / s[None]), -qmax, qmax)
        return q.astype(np.int8), s.astype(np.float32)

    def convert(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and "kernel" in v and k != "embed_tokens":
                q, s = quantize(np.asarray(v["kernel"], np.float32), _wbits_for(k, weight_bits))
                out[k] = {"kernel_q": q, "scale_q": s, **({"bias": v["bias"]} if "bias" in v
                                                         else {})}
            elif isinstance(v, dict):
                out[k] = convert(v)
            else:
                out[k] = v
        return out

    return convert(params)


@torch.no_grad()
def quantize_qwen_text_(model: QwenTextModel, group_size: Optional[int] = None,
                        weight_bits: int = 8) -> QwenTextModel:
    """Quantize a built bf16 text model in place, on its device, to the
    W8A8 (weight_bits=8) or W4A8 (4) format: every nn.Linear (the
    projections and the lm_head; the embedding is not a Linear) becomes a
    `QuantLinear` (at 4 bits with `effective_group`'s scales and the
    lm_head at 8), and each bf16 weight is released as its quantized copy
    lands, so the peak stays near one bf16 copy plus one matrix. The
    modules' configs become weight_dtype "int8" or "int4" with this group
    size. Counterpart of the JAX
    `quantize_qwen_text_params_device(free_source=True)`."""
    # (parent, name) pairs only: a list of the Linears would keep every
    # bf16 weight alive until the end
    targets = [(mod, name) for mod in model.modules()
               for name, child in mod.named_children() if isinstance(child, nn.Linear)]
    group = effective_group(group_size, weight_bits)
    for mod, name in targets:
        setattr(mod, name, QuantLinear.from_linear(getattr(mod, name), group,
                                                   _wbits_for(name, weight_bits)))
    cfg = dataclasses.replace(model.cfg, weight_dtype="int4" if weight_bits == 4 else "int8",
                              quant_group_size=group_size)
    for mod in model.modules():
        if isinstance(getattr(mod, "cfg", None), QwenTextConfig):
            mod.cfg = cfg
    return model


@torch.no_grad()
def greedy_generate(model: QwenTextModel, inputs_embeds, position_ids, *,
                    rope_deltas=None, prompt_lengths=None, segment_ids=None,
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
    is the M-RoPE decode offset (position = length + delta + step). Their
    defaults are the JAX function's: the delta of (3, B, T) positions
    (max + 1 - T; 0 for (B, T) ones), every row T long, one segment.

    The prefill writes into static caches of T + max_new_tokens +
    extra_cache_slots slots made for this call, and the loop runs through
    a `DecodeLoop` of its own (a captured CUDA graph per step on the
    card). A server reuses its caches and graphs across requests instead
    (`InternVLAN1Policy.prefill_s2` and `grouped_tail` on its
    `DecodeBuffers`)."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if rope_deltas is None:
        rope_deltas = (position_ids.amax(dim=(0, 2)) + 1 - T if position_ids.dim() == 3
                       else torch.zeros(B, dtype=torch.long, device=dev))
    if prompt_lengths is None:
        prompt_lengths = torch.full((B,), T, dtype=torch.long, device=dev)
    caches = StaticCaches(model.cfg, B, T + max_new_tokens + extra_cache_slots, dev)
    logits, _, _ = model(inputs_embeds, position_ids, segment_ids=segment_ids,
                         logits_indices=prompt_lengths.long() - 1, caches_out=caches.entries)
    loop = DecodeLoop(model, [caches], max_new_tokens, eos_token_ids)
    tokens, lengths = loop.run(model.greedy_token(logits[:, 0]), prompt_lengths, rope_deltas)
    return tokens, lengths, caches.entries


@torch.no_grad()
def greedy_decode_grouped(model: QwenTextModel, first_tok, cache_groups: Sequence[StaticCaches],
                          *, prompt_lengths, rope_deltas, max_new_tokens: int = 128,
                          eos_token_ids: Tuple[int, ...] = (151645,),
                          buffers: Optional[DecodeBuffers] = None, eager: bool = False):
    """Greedy decode over several prefilled cache groups in one loop: one
    pass over the weights a token for every group (`decode_step_grouped`).
    first_tok (B_total,) is the argmax of each row's prefill logits, the
    groups' rows stacked in order; cache_groups hold each group's prompt
    K/V (`StaticCaches` of T + max_new_tokens + n_query slots);
    prompt_lengths / rope_deltas (B_total,). Each row's tokens equal
    `greedy_generate` on its own group: the loop runs until every row of
    every group is done, and a finished row keeps emitting EOS. Returns
    (tokens (B_total, max_new_tokens), lengths (B_total,)); the caches are
    written in place."""
    buffers = buffers if buffers is not None else DecodeBuffers()
    loop = buffers.loop(model, list(cache_groups), max_new_tokens, eos_token_ids, eager=eager)
    return loop.run(first_tok, prompt_lengths, rope_deltas)
