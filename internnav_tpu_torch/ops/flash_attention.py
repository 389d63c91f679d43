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
from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_HEAD_DIMS = (80, 128)

#: launches of each kernel in this process (its CUDA wrapper adds one per
#: launch; the plain versions never do): K1 forward, K2 dK/dV, K3 dQ
kernel_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0


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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = False,
                         segment_ids: Optional[torch.Tensor] = None,
                         kv_segment_ids: Optional[torch.Tensor] = None,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel: returns (o bf16 (B, H, Tq, D), lse fp32
    (B, H, Tq)). Raises on any input the kernel does not take."""
    global kernel_launches
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    _check_kernel_args(q, k, v, segment_ids, kv_segment_ids, causal)
    fn = _kernel_entry()
    B, H, Tq, D = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 segment_ids.data_ptr() if segment_ids is not None else None,
                 kv_segment_ids.data_ptr() if kv_segment_ids is not None else None,
                 o.data_ptr(), lse.data_ptr(), B, H, KV, Tq, Tk, D,
                 float(sm_scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {err}")
    kernel_launches += 1
    return o, lse


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
    dkv.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    dq.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    dkv.restype = dq.restype = ctypes.c_int
    return dkv, dq


def _bwd_prologue(q, k, v, do, lse, di, segment_ids, kv_segment_ids, causal, sm_scale):
    """Check the backward kernels' inputs; returns (kv_segment_ids, sm_scale)."""
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
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
    return kv_segment_ids, q.shape[-1] ** -0.5 if sm_scale is None else sm_scale


def _seg_ptrs(segment_ids, kv_segment_ids):
    return (segment_ids.data_ptr() if segment_ids is not None else None,
            kv_segment_ids.data_ptr() if kv_segment_ids is not None else None)


def flash_bwd_dkv_cuda(q, k, v, do, lse, di, *, causal: bool = False,
                       segment_ids: Optional[torch.Tensor] = None,
                       kv_segment_ids: Optional[torch.Tensor] = None,
                       sm_scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: returns (dk, dv) bf16 (B, KV, Tk, D), already summed over
    each query-head group. lse is K1's, di = rowsum(dO * O) fp32 (B, H, Tq)."""
    global bwd_dkv_launches
    kv_segment_ids, sm_scale = _bwd_prologue(q, k, v, do, lse, di, segment_ids,
                                             kv_segment_ids, causal, sm_scale)
    fn = _bwd_entries()[0]
    B, H, Tq, D = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 di.data_ptr(), *_seg_ptrs(segment_ids, kv_segment_ids),
                 dk.data_ptr(), dv.data_ptr(), B, H, KV, Tq, Tk, D,
                 float(sm_scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash backward dK/dV kernel launch failed: cudaError_t {err}")
    bwd_dkv_launches += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, di, *, causal: bool = False,
                      segment_ids: Optional[torch.Tensor] = None,
                      kv_segment_ids: Optional[torch.Tensor] = None,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch K3: returns dq bf16 (B, H, Tq, D)."""
    global bwd_dq_launches
    kv_segment_ids, sm_scale = _bwd_prologue(q, k, v, do, lse, di, segment_ids,
                                             kv_segment_ids, causal, sm_scale)
    fn = _bwd_entries()[1]
    B, H, Tq, D = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 di.data_ptr(), *_seg_ptrs(segment_ids, kv_segment_ids),
                 dq.data_ptr(), B, H, KV, Tq, Tk, D, float(sm_scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash backward dQ kernel launch failed: cudaError_t {err}")
    bwd_dq_launches += 1
    return dq


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable kernel attention on CUDA tensors: forward K1, backward
    D_i = rowsum(dO * O) in one torch expression, then K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, causal, sm_scale):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, segment_ids=segment_ids,
                                      kv_segment_ids=kv_segment_ids, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, segment_ids, kv_segment_ids, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, kv_seg, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = (o.float() * do.float()).sum(-1)
        kw = dict(causal=ctx.causal, segment_ids=seg, kv_segment_ids=kv_seg,
                  sm_scale=ctx.sm_scale)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, di, **kw)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, di, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention, (B, H, Tq, D) out. CPU tensors run the plain
    version (autograd differentiates it); CUDA tensors go through the
    kernels (`FlashAttentionFn`) or raise."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention is top-left and needs Tq == Tk")
    if q.is_cuda:
        if segment_ids is not None and kv_segment_ids is None:
            kv_segment_ids = segment_ids
        return FlashAttentionFn.apply(q, k, v, segment_ids, kv_segment_ids, causal, sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention has no path for device {q.device}")
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


def gqa_decode_attention(q, k_cache, v_cache, cache_len, *, sm_scale=None,
                         k_scale=None, v_scale=None):
    """Grouped-query decode without the KV head repeat. q (B, H, D); caches
    (B, KV, Tmax, D); k_scale/v_scale (B, KV, Tmax) dequant scales of an
    int8 cache, or None."""
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
    cache positions < cache_len + i + 1 (stepwise causal)."""
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
