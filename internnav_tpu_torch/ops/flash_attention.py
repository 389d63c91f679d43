"""Attention ops: plain PyTorch versions and the Hopper flash-attention kernels.

Port of internnav_tpu/ops/flash_attention.py. Layout is the JAX package's:
q (B, H, Tq, D), k/v (B, KV, Tk, D), segment ids (B, T) int32.

`flash_attention` dispatches on the tensor's device: a CPU tensor runs the
plain version (`mha_reference`, differentiated by autograd), a CUDA tensor
goes through `FlashAttentionFn`, whose forward is the hand-written kernel
`csrc/flash_fwd.cu` (port of the Pallas `_flash_kernel`) and whose backward
is `csrc/flash_bwd.cu` (ports of `_flash_bwd_dkv_kernel` and
`_flash_bwd_dq_kernel`), or raises. There is no fallback from one to the
other. `flash_backward_reference` is the plain version of the backward.

Decode over an int8 KV cache (`gqa_decode_attention` and
`gqa_chunk_decode_attention` with k_scale/v_scale) runs, on CUDA, the
hand-written kernel `csrc/decode_int8.cu` (K4 for one token, K5 for a
chunk; ports of the XLA int8 branch of the JAX functions); their plain
versions are `gqa_decode_reference` / `gqa_chunk_decode_reference`, which
also serve the bf16 cache on every device.

The three flash kernels compute a (query tile, 64-key tile) pair only when it is
live (`live_tile_mask`): causally live, and its segment ranges
(`tile_segment_ranges`, one table per side, per 64-row tile) overlap. The
backward kernels take 64-query tiles; K1 takes 128-query blocks
(`FWD_QUERY_BLOCK`) and walks a key tile when it is live for either 64-row
half. The tables are built once per segment-id tensor (`segment_tile_tables`)
and handed to every call that shares it (`tile_tables=`).

Differences from the JAX wrapper:
- grouped-query K/V (KV heads dividing H) is taken un-repeated; query head
  h reads KV head h // (H // KV);
- any sequence length runs the kernel (ragged tails are masked), where the
  TPU wrapper dropped to XLA when T had no power-of-two divisor >= 64;
- causal masking is top-left (col <= row) and needs Tq == Tk; the plain
  `mha_reference` keeps the JAX package's bottom-right convention, and the
  two agree exactly when Tq == Tk.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_HEAD_DIMS = (80, 128)
#: rows and keys per tile of the segment tables and the backward kernels
TILE = 64
#: query rows per block of the forward kernel K1 (two 64-row halves)
FWD_QUERY_BLOCK = 128
INT32_MAX, INT32_MIN = 2**31 - 1, -(2**31)

#: launches of each kernel in this process (its CUDA wrapper adds one per
#: launch; the plain versions never do): K1 forward, K2 dK/dV, K3 dQ, and
#: the int8 decode kernel as K4 (one token) and K5 (a chunk of n tokens)
kernel_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0
decode_int8_launches = 0
chunk_decode_int8_launches = 0
#: the counters' names (`decode_graph` adds a captured step's launches to
#: them at every replay of its graph)
LAUNCH_COUNTERS = ("kernel_launches", "bwd_dkv_launches", "bwd_dq_launches",
                   "decode_int8_launches", "chunk_decode_int8_launches")


def _repeat_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    kv = x.shape[1]
    if kv == heads:
        return x
    if heads % kv:
        raise ValueError(f"query heads {heads} not a multiple of KV heads {kv}")
    return x.repeat_interleave(heads // kv, dim=1)


def _attention_mask(q, k, causal, segment_ids, kv_segment_ids):
    """Boolean (B, 1, Tq, Tk) mask of the JAX `mha_reference`, or None."""
    B, Tq, Tk = q.shape[0], q.shape[2], k.shape[2]
    mask = None

    def both(m):
        return m if mask is None else mask & m

    if causal:
        # queries are the last Tq positions of the kv stream (bottom-right)
        cm = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(Tk - Tq)
        mask = both(cm[None, None])
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
        mask = both((segment_ids[:, :, None] == kv_seg[:, None, :])[:, None])
    if mask is not None:
        mask = mask.expand(B, 1, Tq, Tk)
    return mask


def mha_reference(q, k, v, *, causal: bool = False,
                  segment_ids: Optional[torch.Tensor] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None,
                  sm_scale: Optional[float] = None,
                  return_lse: bool = False):
    """Plain attention, the ground truth for the kernel.

    Softmax in fp32; masked logits take -0.7 * f32.max and rows with no
    valid key give 0. Returns o in q's dtype, and with return_lse=True also
    the fp32 per-row logsumexp (B, H, Tq), -inf on fully masked rows."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    H = q.shape[1]
    kf = _repeat_kv(k, H).float()
    vf = _repeat_kv(v, H).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    mask = _attention_mask(q, k, causal, segment_ids, kv_segment_ids)
    if mask is not None:
        s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = p.masked_fill(~mask.any(dim=-1, keepdim=True), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    if not return_lse:
        return o
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return o, torch.logsumexp(s, dim=-1)


def _check_kernel_args(q, k, v, segment_ids, kv_segment_ids, causal):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash attention kernel: {name} must be on {q.device} (CUDA)")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bfloat16, {name} is {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be a contiguous (B, H, T, D) tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} is not 16-byte aligned")
    B, H, Tq, D = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head dim {D} not in {KERNEL_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash attention kernel: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"flash attention kernel: {H} heads not a multiple of {KV} KV heads")
    if causal and Tq != Tk:
        raise ValueError("flash attention kernel: causal needs Tq == Tk")
    if (segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash attention kernel: give both segment id tensors or neither")
    if segment_ids is not None:
        for name, t, T in (("segment_ids", segment_ids, Tq),
                           ("kv_segment_ids", kv_segment_ids, Tk)):
            if t.device != q.device or t.dtype != torch.int32:
                raise TypeError(f"flash attention kernel: {name} must be int32 on {q.device}")
            if tuple(t.shape) != (B, T) or not t.is_contiguous():
                raise ValueError(f"flash attention kernel: {name} must be contiguous {(B, T)}")


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The kernel's C entry point, built and bound once per process."""
    from internnav_tpu_torch.ops._build import load_library

    fn = load_library("flash_fwd.cu").flash_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = False,
                         segment_ids: Optional[torch.Tensor] = None,
                         kv_segment_ids: Optional[torch.Tensor] = None,
                         sm_scale: Optional[float] = None,
                         tile_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         tile_counter: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel: returns (o bf16 (B, H, Tq, D), lse fp32
    (B, H, Tq)). tile_tables: `segment_tile_tables` of these segment ids
    (only their shape, dtype and device are checked), built here when not
    given. tile_counter: an int32 CUDA tensor of one element that gains
    the key tiles the kernel walks (summed over its blocks), or None.
    Raises on any input the kernel does not take."""
    global kernel_launches
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    _check_tile_tables(tile_tables, q, k, segment_ids)
    _check_kernel_args(q, k, v, segment_ids, kv_segment_ids, causal)
    if tile_counter is not None and (tile_counter.device != q.device
                                     or tile_counter.dtype != torch.int32
                                     or tile_counter.numel() != 1):
        raise ValueError(f"flash attention kernel: tile_counter must be one int32 on {q.device}")
    fn = _kernel_entry()
    B, H, Tq, D = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    seg = tabs = (None, None)
    if segment_ids is not None:
        # K1 reads the query ids row by row, and copies 64-key slices
        seg = (segment_ids, _rows_for_kernel(kv_segment_ids, 0))
        tabs = tile_tables if tile_tables is not None else segment_tile_tables(
            segment_ids, kv_segment_ids)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    ptrs = [None if t is None else t.data_ptr() for t in (*seg, *tabs)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, o.data_ptr(), lse.data_ptr(),
                 None if tile_counter is None else tile_counter.data_ptr(), B, H, KV, Tq, Tk, D,
                 float(sm_scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {err}")
    kernel_launches += 1
    return o, lse


# ------------------------------------------------------------- tile skipping
def tile_segment_ranges(segment_ids: torch.Tensor, block: int = TILE) -> torch.Tensor:
    """Per tile of `block` rows of (B, T) int32 segment ids: int32
    (B, ceil(T / block), 4) holding [lo, hi] over the ids >= 0 and [lo, hi]
    over the ids < 0; an empty range is (INT32_MAX, INT32_MIN). The last
    tile counts only its rows < T."""
    B, T = segment_ids.shape
    n = -(-T // block)
    seg = F.pad(segment_ids, (0, n * block - T)).view(B, n, block)
    valid = (torch.arange(n * block, device=seg.device) < T).view(1, n, block)
    pos, neg = valid & (seg >= 0), valid & (seg < 0)
    big = torch.full_like(seg, INT32_MAX)
    small = torch.full_like(seg, INT32_MIN)
    return torch.stack([torch.where(pos, seg, big).amin(-1), torch.where(pos, seg, small).amax(-1),
                        torch.where(neg, seg, big).amin(-1), torch.where(neg, seg, small).amax(-1)],
                       dim=-1).to(torch.int32).contiguous()


def segment_tile_tables(segment_ids: Optional[torch.Tensor],
                        kv_segment_ids: Optional[torch.Tensor] = None
                        ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(query table, key table) of `tile_segment_ranges`, or None without
    segment ids; one table serves both sides when they share their ids.
    Built once per segment-id tensor and passed as `tile_tables=` to every
    kernel call on it (all layers, forward and backward)."""
    if segment_ids is None:
        return None
    q_tab = tile_segment_ranges(segment_ids)
    if kv_segment_ids is None or kv_segment_ids is segment_ids:
        return q_tab, q_tab
    return q_tab, tile_segment_ranges(kv_segment_ids)


def _check_tile_tables(tables, q, k, segment_ids):
    """Raise unless `tables` is None or two contiguous int32 tables of the
    segment ids' shape per 64-row tile, on q's device."""
    if tables is None:
        return
    if segment_ids is None:
        raise ValueError("tile tables given without segment ids")
    B, Tq, Tk = q.shape[0], q.shape[2], k.shape[2]
    if len(tables) != 2:
        raise ValueError("tile tables must be a (query, key) pair")
    for t, T in zip(tables, (Tq, Tk)):
        if tuple(t.shape) != (B, -(-T // TILE), 4) or t.dtype != torch.int32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError("tile tables must be tile_segment_ranges of the segment ids: "
                             f"int32 {(B, -(-T // TILE), 4)} on {q.device}")


def _ranges_overlap(q_tab, kv_tab):
    """(B, nq, nk) bool: a query tile's and a key tile's ranges overlap."""
    a, b = q_tab[:, :, None, :], kv_tab[:, None, :, :]
    pos = torch.maximum(a[..., 0], b[..., 0]) <= torch.minimum(a[..., 1], b[..., 1])
    neg = torch.maximum(a[..., 2], b[..., 2]) <= torch.minimum(a[..., 3], b[..., 3])
    return pos | neg


def live_tile_mask(tq: int, tk: int, *, causal: bool,
                   segment_ids: Optional[torch.Tensor] = None,
                   kv_segment_ids: Optional[torch.Tensor] = None,
                   query_block: int = TILE) -> torch.Tensor:
    """(B, ceil(tq / query_block), ceil(tk / TILE)) bool (B = 1 without
    segment ids): the (query block, key tile) pairs the kernels compute.
    A 64-row query tile and a key tile are live when they are causally live
    (top-left, Tq == Tk) and their ranges over ids >= 0 or their ranges over
    ids < 0 overlap; a block of `query_block` rows (TILE for K2/K3,
    FWD_QUERY_BLOCK for K1) walks the key tiles live for any of its 64-row
    tiles. A dropped pair holds no (q, k) with equal ids, whatever the ids'
    order."""
    if query_block % TILE:
        raise ValueError(f"query_block {query_block} is not a multiple of {TILE}")
    if causal and tq != tk:
        raise ValueError("causal tile skipping needs Tq == Tk")
    nq, nk = -(-tq // TILE), -(-tk // TILE)
    device = segment_ids.device if segment_ids is not None else None
    live = torch.ones((1, nq, nk), dtype=torch.bool, device=device)
    if causal:
        live = live.tril()
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
        live = live & _ranges_overlap(tile_segment_ranges(segment_ids),
                                      tile_segment_ranges(kv_seg))
    group = query_block // TILE
    if group > 1:
        live = F.pad(live, (0, 0, 0, -nq % group))
        live = live.view(live.shape[0], -1, group, nk).any(dim=2)
    return live


def live_tile_pairs(tq: int, tk: int, *, causal: bool,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    query_block: int = TILE) -> int:
    """Live (query block, key tile) pairs of `live_tile_mask`, summed over
    the batch: the key tiles the kernels walk per query head (K2 and K3 at
    the default 64-row blocks, K1 at FWD_QUERY_BLOCK)."""
    return int(live_tile_mask(tq, tk, causal=causal, segment_ids=segment_ids,
                              kv_segment_ids=kv_segment_ids, query_block=query_block).sum())


# ----------------------------------------------------------------- backward
def flash_backward_reference(q, k, v, segment_ids, kv_segment_ids, o, lse, do,
                             causal: bool, sm_scale: Optional[float] = None):
    """Plain backward: the whole-matrix form of the JAX `_flash_backward`.

    P is recomputed from the forward's lse (rows with lse = -inf give
    P = 0), D_i = rowsum(dO * O), dS = P * (dP - D_i) * scale; dK and dV
    are summed over each group of H / KV query heads. fp32 throughout;
    returns (dq, dk, dv) in the dtypes of q, k, v. One KV group at a time,
    so the score matrices held are (B, H / KV, Tq, Tk)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    H, KV = q.shape[1], k.shape[1]
    if H % KV:
        raise ValueError(f"query heads {H} not a multiple of KV heads {KV}")
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash backward needs Tq == Tk")
    G = H // KV
    mask = _attention_mask(q, k, causal, segment_ids, kv_segment_ids)
    di = (o.float() * do.float()).sum(-1)
    finite = torch.isfinite(lse)
    lse_safe = torch.where(finite, lse, 0.0).float()
    dq, dk, dv = [], [], []
    for j in range(KV):
        heads = slice(j * G, (j + 1) * G)
        qf, dof = q[:, heads].float(), do[:, heads].float()
        kf, vf = k[:, j:j + 1].float(), v[:, j:j + 1].float()  # (B, 1, Tk, D)
        s = torch.einsum("bhqd,bkd->bhqk", qf, kf[:, 0]) * sm_scale
        p = torch.exp(s - lse_safe[:, heads, :, None])
        p = p.masked_fill(~finite[:, heads, :, None], 0.0)
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        dp = torch.einsum("bhqd,bkd->bhqk", dof, vf[:, 0])
        ds = p * (dp - di[:, heads, :, None]) * sm_scale
        dv.append(torch.einsum("bhqk,bhqd->bkd", p, dof))
        dk.append(torch.einsum("bhqk,bhqd->bkd", ds, qf))
        dq.append(torch.einsum("bhqk,bkd->bhqd", ds, kf[:, 0]))
    return (torch.cat(dq, dim=1).to(q.dtype), torch.stack(dk, dim=1).to(k.dtype),
            torch.stack(dv, dim=1).to(v.dtype))


@functools.lru_cache(maxsize=None)
def _bwd_entries():
    """The backward kernels' C entry points (dkv, dq), built and bound once."""
    from internnav_tpu_torch.ops._build import load_library

    lib = load_library("flash_bwd.cu")
    dkv, dq = lib.flash_bwd_dkv_bf16, lib.flash_bwd_dq_bf16
    dkv.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    dq.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    dkv.restype = dq.restype = ctypes.c_int
    return dkv, dq


def _rows_for_kernel(x, value):
    """x (..., T) padded to a multiple of TILE rows with `value`, 16-byte
    aligned: the kernels copy whole 64-row slices of it."""
    pad = -x.shape[-1] % TILE
    if pad:
        return F.pad(x, (0, pad), value=value)
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bwd_launch(which, q, k, v, do, lse, di, outs, segment_ids, kv_segment_ids, causal,
                sm_scale, tile_tables):
    """Check the inputs, pad the row vectors, and launch K2 ("dkv") or K3 ("dq")."""
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    _check_tile_tables(tile_tables, q, k, segment_ids)
    _check_kernel_args(q, k, v, segment_ids, kv_segment_ids, causal)
    if do.shape != q.shape or do.dtype != torch.bfloat16 or not do.is_contiguous() \
            or do.device != q.device or do.data_ptr() % 16:
        raise ValueError("flash backward kernel: do must be a contiguous, aligned bfloat16 "
                         f"tensor of q's shape {tuple(q.shape)} on {q.device}")
    for name, t in (("lse", lse), ("di", di)):
        if tuple(t.shape) != tuple(q.shape[:3]) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash backward kernel: {name} must be contiguous float32 "
                             f"{tuple(q.shape[:3])} on {q.device}")
    B, H, Tq, D = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    seg = tabs = (None, None)
    if segment_ids is not None:
        seg = (_rows_for_kernel(segment_ids, 0), _rows_for_kernel(kv_segment_ids, 0))
        tabs = tile_tables if tile_tables is not None else segment_tile_tables(
            segment_ids, kv_segment_ids)
    lse_k = _rows_for_kernel(lse, float("-inf"))
    di_k = _rows_for_kernel(di, 0.0)
    fn = _bwd_entries()[0 if which == "dkv" else 1]
    ptrs = [None if t is None else t.data_ptr() for t in (*seg, *tabs)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse_k.data_ptr(),
                 di_k.data_ptr(), *ptrs, *(o.data_ptr() for o in outs), B, H, KV, Tq, Tk, D,
                 float(sm_scale), int(causal), stream)
    if err != 0:
        name = "dK/dV" if which == "dkv" else "dQ"
        raise RuntimeError(f"flash backward {name} kernel launch failed: cudaError_t {err}")


def flash_bwd_dkv_cuda(q, k, v, do, lse, di, *, causal: bool = False,
                       segment_ids: Optional[torch.Tensor] = None,
                       kv_segment_ids: Optional[torch.Tensor] = None,
                       sm_scale: Optional[float] = None,
                       tile_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: returns (dk, dv) bf16 (B, KV, Tk, D), already summed over
    each query-head group. lse is K1's, di = rowsum(dO * O) fp32 (B, H, Tq).
    tile_tables: `tile_segment_ranges` of (segment_ids, kv_segment_ids),
    computed here when not given."""
    global bwd_dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("dkv", q, k, v, do, lse, di, (dk, dv), segment_ids, kv_segment_ids, causal,
                sm_scale, tile_tables)
    bwd_dkv_launches += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, di, *, causal: bool = False,
                      segment_ids: Optional[torch.Tensor] = None,
                      kv_segment_ids: Optional[torch.Tensor] = None,
                      sm_scale: Optional[float] = None,
                      tile_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """Launch K3: returns dq bf16 (B, H, Tq, D); tile_tables as for K2."""
    global bwd_dq_launches
    dq = torch.empty_like(q)
    _bwd_launch("dq", q, k, v, do, lse, di, (dq,), segment_ids, kv_segment_ids, causal,
                sm_scale, tile_tables)
    bwd_dq_launches += 1
    return dq


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable kernel attention on CUDA tensors: forward K1, backward
    D_i = rowsum(dO * O) in one torch expression, then K2 and K3. The tile
    tables are the caller's (`tile_tables`) or built once here, and the
    backward reuses the forward's."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, causal, sm_scale, tile_tables=None):
        if tile_tables is None:
            tile_tables = segment_tile_tables(segment_ids, kv_segment_ids)
        o, lse = flash_attention_cuda(q, k, v, causal=causal, segment_ids=segment_ids,
                                      kv_segment_ids=kv_segment_ids, sm_scale=sm_scale,
                                      tile_tables=tile_tables)
        ctx.save_for_backward(q, k, v, segment_ids, kv_segment_ids, o, lse,
                              *(tile_tables or (None, None)))
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, kv_seg, o, lse, q_tab, kv_tab = ctx.saved_tensors
        do = do.contiguous()
        di = (o.float() * do.float()).sum(-1)
        kw = dict(causal=ctx.causal, segment_ids=seg, kv_segment_ids=kv_seg,
                  sm_scale=ctx.sm_scale, tile_tables=None if seg is None else (q_tab, kv_tab))
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, di, **kw)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, di, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None,
                    tile_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Multi-head attention, (B, H, Tq, D) out. CPU tensors run the plain
    version (autograd differentiates it; tile_tables are checked and not
    needed); CUDA tensors go through the kernels (`FlashAttentionFn`, whose
    wrapper checks the tables) or raise. tile_tables: `segment_tile_tables`
    of these very segment ids, for a caller that runs many calls on one
    segment-id tensor; only their shape, dtype and device are checked."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention is top-left and needs Tq == Tk")
    if q.is_cuda:
        if segment_ids is not None and kv_segment_ids is None:
            kv_segment_ids = segment_ids
        return FlashAttentionFn.apply(q, k, v, segment_ids, kv_segment_ids, causal, sm_scale,
                                      tile_tables)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention has no path for device {q.device}")
    _check_tile_tables(tile_tables, q, k, segment_ids)
    return mha_reference(q, k, v, causal=causal, segment_ids=segment_ids,
                         kv_segment_ids=kv_segment_ids, sm_scale=sm_scale)


# ------------------------------------------------------------------- decode
def _decode_mask(cache_len: torch.Tensor, Tmax: int) -> torch.Tensor:
    return torch.arange(Tmax, device=cache_len.device)[None, :] < cache_len.reshape(-1, 1)


def decode_attention(q, k_cache, v_cache, cache_len, *, sm_scale=None):
    """Single-token decode over a (B, H, Tmax, D) cache; cache_len (B,)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k_cache.float()) * sm_scale
    mask = _decode_mask(cache_len, k_cache.shape[2])
    s = s.masked_fill(~mask[:, None, :], DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, v_cache.float()).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _decode_int8_entry():
    """K4/K5's C entry point, built and bound once per process."""
    from internnav_tpu_torch.ops._build import load_library

    fn = load_library("decode_int8.cu").decode_int8_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


#: K4/K5: a (batch, KV head) is one thread-block cluster of a block per 64
#: cached keys, at most 16 blocks (the non-portable cluster size)
DECODE_KEYS_PER_BLOCK = 64
DECODE_MAX_CLUSTER = 16


def decode_cluster_size(Tmax: int) -> int:
    """K4/K5's blocks per (batch, KV head): one per 64 keys of the cache,
    at most DECODE_MAX_CLUSTER."""
    return max(1, min(DECODE_MAX_CLUSTER, -(-int(Tmax) // DECODE_KEYS_PER_BLOCK)))


def decode_live_keys(lengths: Sequence[int], len_offset: int, n: int, Tmax: int) -> List[int]:
    """Per batch row, the keys the last query row sees: min(Tmax, length +
    len_offset + n - 1), the work K4/K5 must do for that row."""
    return [max(0, min(Tmax, int(x) + len_offset + n - 1)) for x in lengths]


def _decode_int8_cuda(q, k_cache, v_cache, k_scale, v_scale, lengths, len_offset, sm_scale):
    """Launch K4/K5: q (B, H, n, D) bf16; caches (B, KV, Tmax, D) int8 and
    scales (B, KV, Tmax) fp32, any strides with D contiguous (the model
    passes transposed views of its (B, Tmax, KV, D) cache); query row i sees
    keys t < lengths[b] + len_offset + i. Returns bf16 (B, H, n, D), the
    only tensor it allocates."""
    B, H, n, D = q.shape
    KV, Tmax = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    if q.dtype != torch.bfloat16 or not q.is_cuda:
        raise ValueError(f"int8 decode kernel takes bfloat16 CUDA queries, got {q.dtype} on {dev}")
    if D != 128 or H % KV:
        raise ValueError(f"int8 decode kernel: D={D} (needs 128), H={H} not a multiple of KV={KV}")
    for name, t, dtype, shape in (("k_cache", k_cache, torch.int8, (B, KV, Tmax, D)),
                                  ("v_cache", v_cache, torch.int8, (B, KV, Tmax, D)),
                                  ("k_scale", k_scale, torch.float32, (B, KV, Tmax)),
                                  ("v_scale", v_scale, torch.float32, (B, KV, Tmax))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"int8 decode kernel: {name} must be {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1 or any(s % 16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"int8 decode kernel: {name} needs D contiguous and 16-byte "
                             "aligned rows")
    if lengths.device != dev or tuple(lengths.shape) != (B,):
        raise ValueError(f"int8 decode kernel: lengths must be ({B},) on {dev}")
    q = q.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("int8 decode kernel: q is not 16-byte aligned")
    # capture-safe: the launch goes to the current (capturing) stream, and
    # the cluster size depends on Tmax alone (`decode_cluster_size`), so a
    # replay with new lengths on the device runs the captured plan
    lengths = lengths.to(torch.int64).contiguous()
    out = torch.empty_like(q)
    strides = [*k_cache.stride()[:3], *v_cache.stride()[:3], *k_scale.stride(),
               *v_scale.stride()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _decode_int8_entry()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), *strides, B, H, KV, n, Tmax,
            decode_cluster_size(Tmax), len_offset, float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"int8 decode attention kernel launch failed: cudaError_t {err}")
    return out


def gqa_decode_int8_cuda(q, k_cache, v_cache, cache_len, k_scale, v_scale, *, sm_scale=None):
    """K4: `gqa_decode_attention` over an int8 cache on the card; q (B, H,
    D), cache_len (B,) keys visible (the new token's slot included)."""
    global decode_int8_launches
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    out = _decode_int8_cuda(q[:, :, None], k_cache, v_cache, k_scale, v_scale, cache_len, 0,
                            sm_scale)
    decode_int8_launches += 1
    return out[:, :, 0]


def gqa_chunk_decode_int8_cuda(q, k_cache, v_cache, cache_len, k_scale, v_scale, *,
                               sm_scale=None):
    """K5: `gqa_chunk_decode_attention` over an int8 cache on the card; q
    (B, H, n, D), query i sees keys < cache_len + 1 + i."""
    global chunk_decode_int8_launches
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    out = _decode_int8_cuda(q, k_cache, v_cache, k_scale, v_scale, cache_len, 1, sm_scale)
    chunk_decode_int8_launches += 1
    return out


def gqa_decode_attention(q, k_cache, v_cache, cache_len, *, sm_scale=None,
                         k_scale=None, v_scale=None):
    """Grouped-query decode without the KV head repeat. q (B, H, D); caches
    (B, KV, Tmax, D); k_scale/v_scale (B, KV, Tmax) dequant scales of an
    int8 cache, or None. An int8 cache on CUDA goes to K4
    (`gqa_decode_int8_cuda`); every other call runs the plain version."""
    if q.is_cuda and k_scale is not None:
        return gqa_decode_int8_cuda(q, k_cache, v_cache, cache_len, k_scale, v_scale,
                                    sm_scale=sm_scale)
    return gqa_decode_reference(q, k_cache, v_cache, cache_len, sm_scale=sm_scale,
                                k_scale=k_scale, v_scale=v_scale)


def gqa_decode_reference(q, k_cache, v_cache, cache_len, *, sm_scale=None,
                         k_scale=None, v_scale=None):
    """The plain version of `gqa_decode_attention` (K4's ground truth):
    fp32 logits, scales and softmax on any device."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    B, H, D = q.shape
    KV, Tmax = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, D).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float()) * sm_scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    mask = _decode_mask(cache_len, Tmax)
    s = s.masked_fill(~mask[:, None, None, :], DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    out = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def gqa_chunk_decode_attention(q, k_cache, v_cache, cache_len, *, sm_scale=None,
                               k_scale=None, v_scale=None):
    """Decode of n new tokens in one cache pass: q (B, H, n, D); query i sees
    cache positions < cache_len + i + 1 (stepwise causal). An int8 cache on
    CUDA goes to K5 (`gqa_chunk_decode_int8_cuda`); every other call runs
    the plain version."""
    if q.is_cuda and k_scale is not None:
        return gqa_chunk_decode_int8_cuda(q, k_cache, v_cache, cache_len, k_scale, v_scale,
                                          sm_scale=sm_scale)
    return gqa_chunk_decode_reference(q, k_cache, v_cache, cache_len, sm_scale=sm_scale,
                                      k_scale=k_scale, v_scale=v_scale)


def gqa_chunk_decode_reference(q, k_cache, v_cache, cache_len, *, sm_scale=None,
                               k_scale=None, v_scale=None):
    """The plain version of `gqa_chunk_decode_attention` (K5's ground
    truth)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    B, H, n, D = q.shape
    KV, Tmax = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, n, D).float()
    s = torch.einsum("bkgnd,bktd->bkgnt", qg, k_cache.float()) * sm_scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :]
    limit = cache_len.reshape(-1, 1) + 1 + torch.arange(n, device=q.device)[None]
    mask = torch.arange(Tmax, device=q.device)[None, None, :] < limit[:, :, None]
    s = s.masked_fill(~mask[:, None, None], DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :]
    out = torch.einsum("bkgnt,bktd->bkgnd", p, v_cache.float())
    return out.reshape(B, H, n, D).to(q.dtype)


def segment_ids_from_cu_seqlens(cu_seqlens: torch.Tensor, total_len: int) -> torch.Tensor:
    """cu_seqlens [0, l0, l0+l1, ...] → per-token segment ids (total_len,)."""
    positions = torch.arange(total_len, device=cu_seqlens.device)
    return (positions[:, None] >= cu_seqlens[None, 1:-1]).sum(-1).to(torch.int32)
