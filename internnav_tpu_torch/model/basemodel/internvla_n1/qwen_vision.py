"""Qwen2.5-VL vision tower — windowed ViT + 2x2 patch merger.

Port of internnav_tpu/model/basemodel/internvla_n1/qwen_vision.py. The
host-side index bookkeeping (`vision_indices`, `rotary_table`,
`preprocess_images`) is numpy, copied as is. On the device a block attends
either block-diagonally (uniform windows: reshape + batched attention) or
through `flash_attention` with window/image segment ids (ragged windows,
e.g. 420x420 frames): the Hopper kernel at head dim 80 on CUDA.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import RMSNorm
from internnav_tpu_torch.ops.flash_attention import flash_attention, segment_tile_tables


@dataclasses.dataclass(frozen=True)
class QwenVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls) -> "QwenVisionConfig":
        return cls(depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                   window_size=56, fullatt_block_indexes=(1,), out_hidden_size=64)


# ------------------------------------------------------- host-side indexing
@functools.lru_cache(maxsize=32)
def vision_indices(cfg_key: Tuple, grid_thw_key: Tuple) -> Dict[str, np.ndarray]:
    """Window permutation + segment ids + rotary pos ids for a grid set.

    cfg_key = (patch_size, spatial_merge_size, window_size); grid_thw_key =
    tuple of (t, h, w) per image. Cached per shape (a camera's grid is
    fixed)."""
    patch_size, merge, window = cfg_key
    grid_thw = np.asarray(grid_thw_key)
    unit = merge * merge
    vit_ws = window // merge // patch_size

    window_index: List[np.ndarray] = []
    win_seqlens: List[int] = []
    pos_list: List[np.ndarray] = []
    idx_base = 0
    for t, h, w in grid_thw:
        lh, lw = h // merge, w // merge
        index = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h = (-lh) % vit_ws
        pad_w = (-lw) % vit_ws
        nh, nw = (lh + pad_h) // vit_ws, (lw + pad_w) // vit_ws
        padded = np.pad(index, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-100)
        padded = padded.reshape(t, nh, vit_ws, nw, vit_ws).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nh * nw, vit_ws, vit_ws)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        window_index.append(flat[flat != -100] + idx_base)
        win_seqlens.extend((seqlens * unit).tolist())
        idx_base += t * lh * lw

        # rotary (h, w) ids in merged-block order (HF rot_pos_emb)
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hpos = hpos.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wpos = wpos.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        pos_list.append(np.tile(np.stack([hpos, wpos], axis=-1), (t, 1)))

    window_index = np.concatenate(window_index)
    pos_ids = np.concatenate(pos_list, axis=0)  # (S, 2)
    seq_len = pos_ids.shape[0]
    full_seqlens = np.repeat(grid_thw[:, 1] * grid_thw[:, 2], grid_thw[:, 0])
    full_seg = np.repeat(np.arange(len(full_seqlens)), full_seqlens)
    win_seg = np.repeat(np.arange(len(win_seqlens)), win_seqlens)
    pos_units = pos_ids.reshape(seq_len // unit, unit, 2)[window_index].reshape(seq_len, 2)
    full_seg_units = full_seg.reshape(seq_len // unit, unit)[window_index].reshape(seq_len)
    reverse = np.argsort(window_index, kind="stable")
    # uniform windows (resp. images) attend block-diagonally by reshape
    window_block = int(win_seqlens[0]) if len(set(win_seqlens)) == 1 else 0
    full_block = int(full_seqlens[0]) if len(set(full_seqlens.tolist())) == 1 else 0
    return {
        "window_index": window_index.astype(np.int32),
        "reverse_index": reverse.astype(np.int32),
        "pos_ids": pos_units.astype(np.int32),
        "window_segments": win_seg.astype(np.int32),
        "full_segments": full_seg_units.astype(np.int32),
        "seq_len": np.int32(seq_len),
        "window_block": window_block,
        "full_block": full_block,
    }


def rotary_table(pos_ids: np.ndarray, head_dim: int, theta: float = 10000.0):
    """(S, 2) h/w ids → cos/sin (S, head_dim), half for h and half for w."""
    dim_half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, dim_half, 2, dtype=np.float64) / dim_half))
    ang = np.concatenate([pos_ids[:, 0:1] * inv[None], pos_ids[:, 1:2] * inv[None]], axis=-1)
    emb = np.concatenate([ang, ang], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


# ---------------------------------------------------------------- modules
class VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        self.cfg = cfg
        E, I, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        self.norm1 = RMSNorm(E, 1e-6)
        self.qkv = nn.Linear(E, 3 * E, dtype=dt)
        self.proj = nn.Linear(E, E, dtype=dt)
        self.norm2 = RMSNorm(E, 1e-6)
        self.gate_proj = nn.Linear(E, I, dtype=dt)
        self.up_proj = nn.Linear(E, I, dtype=dt)
        self.down_proj = nn.Linear(I, E, dtype=dt)

    def forward(self, x, cos, sin, segment_ids, block: int = 0, tile_tables=None):
        """x (S, E) token-major; segment_ids (S,). block > 0: the segments
        are uniform contiguous `block`-token runs, attended block-diagonally.
        tile_tables: `segment_tile_tables(segment_ids[None])`, or None (the
        kernel wrapper builds them)."""
        c = self.cfg
        H = c.num_heads
        D = c.hidden_size // H
        # the norms' fp32 products enter the bf16 Dense layers cast once
        q, k, v = self.qkv(self.norm1(x).to(c.dtype)).chunk(3, dim=-1)

        def rope(t):  # fp32, as in the JAX tower
            t = t.reshape(-1, H, D).float()
            half = D // 2
            rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
            return t * cos[:, None] + rot * sin[:, None]

        q = rope(q).to(c.dtype)
        k = rope(k).to(c.dtype)
        v = v.reshape(-1, H, D).to(c.dtype)
        if block:
            S = q.shape[0]
            qb, kb, vb = (t.reshape(S // block, block, H, D).float() for t in (q, k, v))
            scores = torch.einsum("bqhd,bkhd->bhqk", qb, kb) / np.sqrt(D)
            probs = torch.softmax(scores, dim=-1).to(c.dtype).float()
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, vb)
            out = attn.to(c.dtype).reshape(-1, c.hidden_size)
        else:
            attn = flash_attention(q.transpose(0, 1)[None].contiguous(),
                                   k.transpose(0, 1)[None].contiguous(),
                                   v.transpose(0, 1)[None].contiguous(),
                                   causal=False, segment_ids=segment_ids[None],
                                   tile_tables=tile_tables)
            out = attn[0].transpose(0, 1).reshape(-1, c.hidden_size)
        x = x + self.proj(out)
        y = self.norm2(x).to(c.dtype)
        return x + self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y))


class QwenVisionTower(nn.Module):
    """pixel patches (S, patch_dim) + host indices → merged tokens
    (S / merge_unit, out_hidden_size) in original order."""

    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        self.cfg = cfg
        E, dt = cfg.hidden_size, cfg.dtype
        unit = cfg.spatial_merge_size ** 2
        patch_dim = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
        self.patch_embed = nn.Linear(patch_dim, E, bias=False, dtype=dt)
        self.blocks = nn.ModuleList(VisionBlock(cfg) for _ in range(cfg.depth))
        self.merger_ln_q = RMSNorm(E, 1e-6)
        self.merger_fc1 = nn.Linear(unit * E, unit * E, dtype=dt)
        self.merger_fc2 = nn.Linear(unit * E, cfg.out_hidden_size, dtype=dt)

    def forward(self, patches, cos, sin, window_segments, full_segments,
                window_index, reverse_index, window_block: int = 0,
                full_block: int = 0):
        """The tile tables of each segment set that runs the flash kernel
        (window and full attention) are built once and shared by its blocks."""
        c = self.cfg
        unit = c.spatial_merge_size ** 2
        x = self.patch_embed(patches.to(c.dtype))
        S = x.shape[0]
        # permute into window order at merge-unit granularity
        x = x.reshape(S // unit, unit, -1)[window_index.long()].reshape(S, -1)
        tables = {full: None if block else segment_tile_tables(seg[None])
                  for full, seg, block in ((False, window_segments, window_block),
                                           (True, full_segments, full_block))}
        for i, blk in enumerate(self.blocks):
            full = i in c.fullatt_block_indexes
            x = blk(x, cos, sin, full_segments if full else window_segments,
                    block=full_block if full else window_block, tile_tables=tables[full])
        x = self.merger_ln_q(x).to(c.dtype).reshape(S // unit, unit * c.hidden_size)
        x = F.gelu(self.merger_fc1(x), approximate="tanh")  # flax nn.gelu default
        x = self.merger_fc2(x)
        return x[reverse_index.long()]


def preprocess_images(images: np.ndarray, cfg: QwenVisionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: (N, H, W, 3) normalized images → (patches, grid_thw), in
    the Qwen processor's patch layout (temporal patch 2: images repeated,
    channel-major flattening per patch)."""
    n, H, W, _ = images.shape
    p, tp, m = cfg.patch_size, cfg.temporal_patch_size, cfg.spatial_merge_size
    gh, gw = H // p, W // p
    patches_all, grids = [], []
    for img in images:
        x = np.repeat(img[None], tp, axis=0).transpose(0, 3, 1, 2)  # (tp, 3, H, W)
        x = x.reshape(tp, 3, gh // m, m, p, gw // m, m, p)
        x = x.transpose(2, 5, 3, 6, 1, 0, 4, 7)
        patches_all.append(x.reshape(gh * gw, 3 * tp * p * p))
        grids.append((1, gh, gw))
    return np.concatenate(patches_all, axis=0), np.asarray(grids, np.int64)


def encode_images(tower: QwenVisionTower, images: np.ndarray,
                  mean=(0.48145466, 0.4578275, 0.40821073),
                  std=(0.26862954, 0.26130258, 0.27577711)):
    """Host normalize + patchify, then the tower on its device: (N, H, W, 3)
    pixels in [0, 255] → (tokens (N_tok, out), grid_thw)."""
    cfg = tower.cfg
    imgs = (np.asarray(images, np.float32) / 255.0 - np.asarray(mean)) / np.asarray(std)
    patches, grid_thw = preprocess_images(imgs, cfg)
    idx = vision_indices((cfg.patch_size, cfg.spatial_merge_size, cfg.window_size),
                         tuple(map(tuple, grid_thw.tolist())))
    cos, sin = rotary_table(idx["pos_ids"], cfg.hidden_size // cfg.num_heads)
    dev = next(tower.parameters()).device
    args = (patches, cos, sin, idx["window_segments"], idx["full_segments"],
            idx["window_index"], idx["reverse_index"])
    with torch.inference_mode():
        tokens = tower(*(torch.as_tensor(a, device=dev) for a in args),
                       window_block=idx["window_block"], full_block=idx["full_block"])
    return tokens, grid_thw


def preprocess_images_device(images: torch.Tensor, cfg: QwenVisionConfig, mean, std) -> torch.Tensor:
    """Device-side normalize + patchify: (N, H, W, 3) uint8 → patches
    (N*gh*gw, 3*tp*p*p) fp32, the layout of `preprocess_images`; only the
    uint8 pixels cross the host-device link."""
    p, tp, m = cfg.patch_size, cfg.temporal_patch_size, cfg.spatial_merge_size
    N, H, W, _ = images.shape
    gh, gw = H // p, W // p
    mean = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    x = x[:, None].expand(N, tp, H, W, 3).permute(0, 1, 4, 2, 3)  # (N, tp, 3, H, W)
    x = x.reshape(N, tp, 3, gh // m, m, p, gw // m, m, p)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(N * gh * gw, 3 * tp * p * p)
