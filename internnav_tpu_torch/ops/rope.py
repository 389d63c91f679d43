"""Rotary position embeddings: 1-D RoPE and Qwen2.5-VL multimodal M-RoPE.

Port of internnav_tpu/ops/rope.py. `get_rope_index_25` and
`get_rope_index_2` are the host-side numpy walks, copied as they are (the
JAX module imports jax, so it cannot be shared).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def rope_inv_freq(dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


@functools.lru_cache(maxsize=None)
def _inv_freq_tensor(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """`rope_inv_freq` as an fp32 tensor on `device`, uploaded once: a
    decode step captured in a CUDA graph may not copy from the host."""
    return torch.as_tensor(rope_inv_freq(dim, theta), dtype=torch.float32, device=device)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float = 10000.0,
                 dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., T) → cos/sin (..., T, dim), frequencies duplicated
    [f0..f_{d/2-1}, f0..f_{d/2-1}] (HF convention)."""
    inv = _inv_freq_tensor(dim, float(theta), positions.device)
    ang = positions[..., None].float() * inv
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q, k, cos, sin):
    """q/k (B, H, T, D); cos/sin (B, T, D). Runs in the q/k dtype, like HF
    (the text model's `apply_rotary`, internnav_tpu qwen_text.py:375-387)."""
    cos = cos[:, None].to(q.dtype)
    sin = sin[:, None].to(q.dtype)
    q_out = q * cos + rotate_half(q) * sin
    k_out = k * cos + rotate_half(k) * sin
    return q_out, k_out.to(k.dtype)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k (B, H, T, D); cos/sin (B, T, D) or (T, D). The products run in
    the promoted dtype (bf16 q with fp32 tables: fp32) and are cast back to
    q's and k's dtypes, as the JAX `apply_rope` does (`apply_rotary` casts
    the tables to q's dtype first, as HF's text attention does)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, None], sin[:, None]  # (B, 1, T, D)
    q_out = q * cos + rotate_half(q) * sin
    k_out = k * cos + rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def mrope_cos_sin(position_ids: torch.Tensor, dim: int, mrope_section: Sequence[int],
                  theta: float = 1000000.0, dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE: position_ids (3, B, T) t/h/w streams; frequency band
    i of mrope_section reads stream i; duplicated to the full head dim."""
    sections = list(mrope_section)
    if sum(sections) != dim // 2:
        raise ValueError(f"mrope_section {sections} does not cover dim {dim}")
    inv = _inv_freq_tensor(dim, float(theta), position_ids.device)
    parts_c, parts_s = [], []
    start = 0
    for stream, sec in enumerate(sections):
        ang = position_ids[stream][..., None].float() * inv[start:start + sec]
        parts_c.append(ang.cos())
        parts_s.append(ang.sin())
        start += sec
    cos_half = torch.cat(parts_c, dim=-1)
    sin_half = torch.cat(parts_s, dim=-1)
    cos = torch.cat([cos_half, cos_half], dim=-1)
    sin = torch.cat([sin_half, sin_half], dim=-1)
    return cos.to(dtype), sin.to(dtype)


def get_rope_index_25(
    input_ids: np.ndarray,
    image_grid_thw: Optional[np.ndarray],
    video_grid_thw: Optional[np.ndarray] = None,
    *,
    spatial_merge_size: int = 2,
    image_token_id: int = 151655,
    video_token_id: int = 151656,
    vision_start_token_id: int = 151652,
    second_per_grid_ts: Optional[Sequence[float]] = None,
    tokens_per_second: float = 2.0,
    attention_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """3-D rotary position indices for Qwen2.5-VL (host-side numpy).

    input_ids (B, T) → (position_ids (3, B, T), rope_deltas (B, 1)). Text
    advances all three streams together; each image/video grid gets
    temporal/row/col indices after the preceding text, and the following
    text resumes at max(position) + 1."""
    input_ids = np.asarray(input_ids)
    B, T = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    position_ids = np.ones((3, B, T), dtype=np.int64)
    rope_deltas = np.zeros((B, 1), dtype=np.int64)
    img_ptr = 0
    vid_ptr = 0
    for b in range(B):
        ids = input_ids[b][attention_mask[b] == 1]
        pos_list: List[np.ndarray] = []
        current_max = -1

        def emit_text(n):
            nonlocal current_max
            if n <= 0:
                return
            p = np.arange(n) + current_max + 1
            pos_list.append(np.tile(p, (3, 1)))
            current_max = int(p[-1])

        i = 0
        n = len(ids)
        while i < n:
            tok = ids[i]
            if tok == image_token_id or tok == video_token_id:
                if tok == image_token_id:
                    t_g, h_g, w_g = (int(x) for x in image_grid_thw[img_ptr])
                    t_scale = 0.0
                    is_image = True
                else:
                    t_g, h_g, w_g = (int(x) for x in video_grid_thw[vid_ptr])
                    spg = second_per_grid_ts[vid_ptr] if second_per_grid_ts else 1.0
                    t_scale = float(spg) * tokens_per_second
                    is_image = False
                h = h_g // spatial_merge_size
                w = w_g // spatial_merge_size
                ntok = t_g * h * w
                base = current_max + 1
                t_idx = (np.arange(t_g).reshape(t_g, 1).repeat(h * w, 1)).reshape(-1)
                if t_scale > 0:
                    t_idx = (t_idx * t_scale).astype(np.int64)
                h_idx = np.tile(np.arange(h).reshape(1, h, 1).repeat(w, 2).reshape(1, -1),
                                (t_g, 1)).reshape(-1)
                w_idx = np.tile(np.arange(w).reshape(1, 1, w).repeat(h, 1).reshape(1, -1),
                                (t_g, 1)).reshape(-1)
                pos = np.stack([t_idx, h_idx, w_idx]) + base
                pos_list.append(pos)
                current_max = int(pos.max())
                if is_image:
                    img_ptr += 1
                else:
                    vid_ptr += 1
                i += ntok
            else:
                j = i
                while j < n and ids[j] != image_token_id and ids[j] != video_token_id:
                    j += 1
                emit_text(j - i)
                i = j
        full = np.concatenate(pos_list, axis=1) if pos_list else np.zeros((3, 0), np.int64)
        position_ids[:, b, attention_mask[b] == 1] = full[:, :n]
        rope_deltas[b, 0] = (full.max() + 1 if full.size else 0) - n
    return position_ids, rope_deltas


def get_rope_index_2(
    input_ids: np.ndarray,
    image_grid_thw: Optional[np.ndarray],
    video_grid_thw: Optional[np.ndarray] = None,
    *,
    spatial_merge_size: int = 2,
    image_token_id: int = 151655,
    video_token_id: int = 151656,
    vision_start_token_id: int = 151652,
    attention_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Qwen2-VL 3-D rotary indices: the walk of `get_rope_index_25`, with
    video time advancing one index per temporal grid (no seconds-per-grid
    scaling)."""
    return get_rope_index_25(
        input_ids, image_grid_thw, video_grid_thw,
        spatial_merge_size=spatial_merge_size,
        image_token_id=image_token_id, video_token_id=video_token_id,
        vision_start_token_id=vision_start_token_id,
        second_per_grid_ts=None, tokens_per_second=1.0,
        attention_mask=attention_mask,
    )
