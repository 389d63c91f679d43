"""int8 quantization ops of the `realtime` serving profile: plain PyTorch
versions and their hand-written Hopper kernels.

Ports the XLA math of internnav_tpu/model/basemodel/internvla_n1/qwen_text.py:

- `quantize_rows`: the per-token activation quantization of `QuantDense`
  (`:173-176`); kernel K6a (Triton, `_quantize_rows_kernel`).
- `w8a8_linear_reference`: its int8 x int8 product and fp32 epilogue
  (`:177-199`), per-channel or grouped scales; kernel K6b
  (`csrc/w8a8_gemm.cu`, CUDA C++ for sm_90a).
- `quantize_kv` (`:527-537`) and the quantized cache write of
  `_write_cache` / `_write_cache_chunk` (`:556-583`): `write_kv_cache_reference`;
  kernel K7 (Triton, `_write_kv_kernel`), which quantizes K and V and stores
  them into the (B, Tmax, KV, D) int8 cache and its (B, Tmax, KV, 1) fp32
  scales in place. Where a write lands, past Tmax too, is the JAX rule
  (`cache_write_slots`), which the bf16 cache write shares.

The dispatchers (`quantize_activations`, `w8a8_linear`, `write_kv_cache`)
send a CPU tensor to the plain version and a CUDA tensor to the kernel, or
raise: there is no fallback from one to the other. Each kernel wrapper adds
one to its launch count per launch. Triton is imported, and the kernels
are built, on the first CUDA call, never when this module is imported.

Rounding is the JAX package's: `round` half to even (`rint` in the
kernels), and every division IEEE-rounded (`div_rn` in Triton; the CUDA
build has no fast-math flag), so that the int8 codes match bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

#: launches of each kernel in this process (its CUDA wrapper adds one per
#: launch; the plain versions never do): K6a activation quantization, K6b
#: W8A8 GEMM, K7 KV quantization + cache write
quantize_rows_launches = 0
w8a8_launches = 0
kv_write_launches = 0

#: K6b takes K in 64-wide chunks; a grouped scale covers whole chunks
GEMM_K_CHUNK = 64
#: K6b's decode tiles serve M <= 16; above, its prefill tiles (128 output
#: rows by 256 columns where N > 1024, else 128; chosen in w8a8_gemm.cu)
GEMM_DECODE_MAX_M = 16

KVEntry = Tuple[torch.Tensor, torch.Tensor]  # (int8 data (B, T, KV, D), fp32 scale (B, T, KV, 1))


# ---------------------------------------------------------- plain versions
def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, IEEE-rounded on every device. The divisor is a tensor of
    t's shape: PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which differs from the division in the last bit."""
    return t / torch.full_like(t, 127.0)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization over the last axis:
    a_scale = max(amax, 1e-8) / 127, q = clip(round(x / a_scale), -127, 127).
    Returns (q int8 (..., K), a_scale fp32 (..., 1))."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    a_scale = div127(amax.clamp(min=1e-8))
    return torch.round(xf / a_scale).clamp(-127, 127).to(torch.int8), a_scale


def grouped_scales(in_features: int, group_size: Optional[int]) -> Optional[int]:
    """The group size `QuantDense` uses for this input width: group_size
    when it divides in_features, else None (per-channel scales)."""
    if group_size and in_features % int(group_size) == 0:
        return int(group_size)
    return None


def w8a8_linear_reference(xq: torch.Tensor, a_scale: torch.Tensor, weight_q: torch.Tensor,
                          scale_q: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = (xq @ weight_qᵀ) dequantized: xq (M, K) int8, a_scale (M, 1)
    fp32, weight_q (N, K) int8, scale_q (N,) or (K / group_size, N) fp32,
    bias (N,) fp32 or None. The integer product is exact (its sums of
    int8 x int8 products stay below 2^31, and float64 holds every such
    integer, so the float64 matmul equals an int32 accumulation on every
    device); the epilogue is the JAX order: per-channel
    float(y32) * a_scale * scale, grouped sum_g(float(y32_g) * scale[g]) *
    a_scale, then + bias, all in fp32, cast to out_dtype."""
    M, K = xq.shape
    N = weight_q.shape[0]
    xd, wd = xq.double(), weight_q.double()
    if scale_q.dim() == 2:
        G = scale_q.shape[0]
        g = K // G
        y32 = torch.einsum("mgk,ngk->gmn", xd.view(M, G, g), wd.view(N, G, g))
        y = (y32.float() * scale_q[:, None, :]).sum(0) * a_scale
    else:
        y = (xd @ wd.T).float() * a_scale * scale_q
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over head_dim: x (..., D) → (int8
    (..., D), fp32 scale (..., 1)) with scale = max(amax / 127, 1e-8) (not
    the activation scale's expression: the clamp comes after the
    division)."""
    xf = x.float()
    s = div127(xf.abs().amax(-1, keepdim=True)).clamp(min=1e-8)
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s


def cache_write_slots(cache_len: torch.Tensor, n: int, Tmax: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where an n-token cache write at positions cache_len (B,) lands, by the
    JAX package's rule (qwen_text.py `_write_cache_chunk` / `_write_cache`):
    a chunk (n > 1), and the single token of a one-row batch, start at
    min(cache_len, Tmax - n) (`dynamic_update_slice` clamps its start); the
    single token of a row of a larger batch at or past Tmax is dropped
    (`.at[].set`). Returns (cols (B, n) int64: the slots written, keep
    (B, 1) bool: False for a dropped row, whose slot Tmax - 1 keeps its old
    value)."""
    B = cache_len.shape[0]
    if n > Tmax:
        raise ValueError(f"a write of {n} tokens does not fit a cache of {Tmax}")
    pos = cache_len.reshape(B, 1).long()
    if n == 1 and B > 1:
        keep = pos < Tmax
        start = pos.clamp(max=Tmax - 1)
    else:
        keep = torch.ones_like(pos, dtype=torch.bool)
        start = pos.clamp(min=0, max=Tmax - n)
    return start + torch.arange(n, device=pos.device), keep


def store_cache_rows_(cache: torch.Tensor, new: torch.Tensor, cols: torch.Tensor,
                      keep: torch.Tensor) -> None:
    """cache (B, Tmax, ...)[b, cols[b]] = new (B, n, ...) in place, for the
    rows `keep` marks (`cache_write_slots`); no host synchronisation."""
    B, n = cols.shape
    rows = torch.arange(B, device=cache.device)[:, None]
    new = new.to(cache.dtype)
    if n == 1 and B > 1:  # the only rule that drops rows
        keep = keep.reshape(B, 1, *(1,) * (new.dim() - 2))
        new = torch.where(keep, new, cache[rows, cols])
    cache[rows, cols] = new


def write_kv_cache_reference(k: torch.Tensor, v: torch.Tensor, k_entry: KVEntry,
                             v_entry: KVEntry, cache_len: torch.Tensor) -> None:
    """Quantize k/v (B, n, KV, D) and write them into the int8 cache entries
    at positions cache_len[b] + i, in place, placed by `cache_write_slots`."""
    cols, keep = cache_write_slots(cache_len, k.shape[1], k_entry[0].shape[1])
    for new, (data, scale) in ((k, k_entry), (v, v_entry)):
        q, s = quantize_kv(new)
        store_cache_rows_(data, q, cols, keep)
        store_cache_rows_(scale, s, cols, keep)


# ------------------------------------------------------------ dispatchers
def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows` of a (M, K) tensor: the plain version on the CPU,
    K6a on CUDA (bf16 or fp32)."""
    if x.is_cuda:
        return quantize_rows_cuda(x)
    _require_cpu(x, "quantize_activations")
    return quantize_rows(x)


def w8a8_linear(xq, a_scale, weight_q, scale_q, bias=None, *,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The W8A8 product: plain version on the CPU, K6b on CUDA (bf16 out).
    scale_q (N,) is per-channel, (G, N) grouped over K / G inputs."""
    if xq.is_cuda:
        if out_dtype != torch.bfloat16:
            raise TypeError(f"W8A8 kernel writes bfloat16, not {out_dtype}")
        return w8a8_linear_cuda(xq, a_scale, weight_q, scale_q, bias)
    _require_cpu(xq, "w8a8_linear")
    return w8a8_linear_reference(xq, a_scale, weight_q, scale_q, bias, out_dtype=out_dtype)


def write_kv_cache(k, v, k_entry: KVEntry, v_entry: KVEntry, cache_len) -> None:
    """Quantize k/v (B, n, KV, D) into the int8 cache at cache_len (B,), in
    place: the plain version on the CPU, K7 on CUDA."""
    if k.is_cuda:
        write_kv_cache_cuda(k, v, k_entry, v_entry, cache_len)
        return
    _require_cpu(k, "write_kv_cache")
    write_kv_cache_reference(k, v, k_entry, v_entry, cache_len)


def _require_cpu(t, name):
    if t.device.type != "cpu":
        raise ValueError(f"{name} has no path for device {t.device}")


# ------------------------------------------------------ K6a (Triton, CUDA)
@functools.lru_cache(maxsize=None)
def _quantize_rows_kernel():
    """K6a, replacing the XLA activation quantization of `QuantDense`
    (qwen_text.py:173-176). One program per row: a pass for amax, a pass
    that writes the int8 codes. Bound by bytes (the input read twice, bf16
    or fp32, and one byte written per element); the row stays in L1/L2
    between the passes."""
    import triton
    import triton.language as tl
    import triton.language.extra.libdevice as tld

    @triton.jit
    def quantize_rows_kernel(x_ptr, q_ptr, s_ptr, K, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK)
        amax = tl.zeros((BLOCK,), tl.float32)
        for k0 in range(0, K, BLOCK):
            x = tl.load(x_ptr + row * K + k0 + offs, mask=k0 + offs < K, other=0.0)
            amax = tl.maximum(amax, tl.abs(x.to(tl.float32)))
        a_scale = tld.div_rn(tl.maximum(tl.max(amax, axis=0), 1e-8), 127.0)
        for k0 in range(0, K, BLOCK):
            m = k0 + offs < K
            x = tl.load(x_ptr + row * K + k0 + offs, mask=m, other=0.0).to(tl.float32)
            q = tl.minimum(tl.maximum(tld.rint(tld.div_rn(x, a_scale)), -127.0), 127.0)
            tl.store(q_ptr + row * K + k0 + offs, q.to(tl.int8), mask=m)
        tl.store(s_ptr + row, a_scale)

    return quantize_rows_kernel


def quantize_rows_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6a on a contiguous bf16 or fp32 (M, K) CUDA tensor (the
    RMSNorm products are fp32, other inputs bf16): returns (int8 (M, K),
    fp32 (M, 1))."""
    global quantize_rows_launches
    if not x.is_cuda or x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2 \
            or not x.is_contiguous():
        raise ValueError("activation quantization kernel takes a contiguous bfloat16 or float32 "
                         f"(M, K) CUDA tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M:
        with torch.cuda.device(x.device):
            _quantize_rows_kernel()[(M,)](x, q, s, K, BLOCK=1024, num_warps=4)
    quantize_rows_launches += 1
    return q, s


# --------------------------------------------------------- K6b (CUDA C++)
@functools.lru_cache(maxsize=None)
def _gemm_entry():
    """K6b's C entry point, built and bound once per process."""
    from internnav_tpu_torch.ops._build import load_library

    fn = load_library("w8a8_gemm.cu").w8a8_gemm
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"W8A8 kernel: {name} must be a contiguous, 16-byte aligned {dtype} "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def w8a8_linear_cuda(xq, a_scale, weight_q, scale_q, bias=None) -> torch.Tensor:
    """Launch K6b: xq (M, K) int8, a_scale (M, 1) fp32, weight_q (N, K)
    int8 (K contiguous), scale_q (N,) or (G, N) fp32, bias (N,) fp32 or
    None → bf16 (M, N). K must be a multiple of 64, a group a multiple of
    64. Raises on anything else."""
    global w8a8_launches
    if not xq.is_cuda:
        raise ValueError("W8A8 kernel: xq must be a CUDA tensor")
    dev = xq.device
    M, K = xq.shape
    N = weight_q.shape[0]
    if K % GEMM_K_CHUNK:
        raise ValueError(f"W8A8 kernel: K={K} is not a multiple of {GEMM_K_CHUNK}")
    _check_cuda("xq", xq, torch.int8, (M, K), dev)
    _check_cuda("a_scale", a_scale, torch.float32, (M, 1), dev)
    _check_cuda("weight_q", weight_q, torch.int8, (N, K), dev)
    group = 0
    if scale_q.dim() == 2:
        G = scale_q.shape[0]
        group = K // G if G and K % G == 0 else 0
        if not group or group % GEMM_K_CHUNK:
            raise ValueError(f"W8A8 kernel: {G} scale groups over K={K} are not whole "
                             f"{GEMM_K_CHUNK}-wide chunks")
    _check_cuda("scale_q", scale_q, torch.float32, (K // group, N) if group else (N,), dev)
    if bias is not None:
        _check_cuda("bias", bias, torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _gemm_entry()(xq.data_ptr(), a_scale.data_ptr(), weight_q.data_ptr(),
                                scale_q.data_ptr(), None if bias is None else bias.data_ptr(),
                                out.data_ptr(), M, N, K, group, stream)
        if err != 0:
            raise RuntimeError(f"W8A8 kernel launch failed: cudaError_t {err}")
    w8a8_launches += 1
    return out


# ------------------------------------------------------- K7 (Triton, CUDA)
@functools.lru_cache(maxsize=None)
def _write_kv_kernel():
    """K7, replacing `quantize_kv` + `_write_cache` / `_write_cache_chunk`
    (qwen_text.py:527-583) for int8 entries. One program per (token, KV
    head, K or V): amax over D, the int8 codes and the scale stored at
    slot cache_len + i of the cache, placed by `cache_write_slots`' rule on
    the device (DROP: a single token of a multi-row batch, dropped at or
    past Tmax; otherwise the start clamped to Tmax - n). Bound by bytes."""
    import triton
    import triton.language as tl
    import triton.language.extra.libdevice as tld

    @triton.jit
    def quantize_store(src_ptr, data_ptr, scale_ptr, src_off, dst_row, offs, keep,
                       D: tl.constexpr):
        x = tl.load(src_ptr + src_off + offs).to(tl.float32)
        s = tl.maximum(tld.div_rn(tl.max(tl.abs(x), axis=0), 127.0), 1e-8)
        q = tl.minimum(tl.maximum(tld.rint(tld.div_rn(x, s)), -127.0), 127.0)
        tl.store(data_ptr + dst_row * D + offs, q.to(tl.int8), mask=keep)
        tl.store(scale_ptr + dst_row, s, mask=keep)

    @triton.jit
    def write_kv_kernel(k_ptr, v_ptr, kd_ptr, ks_ptr, vd_ptr, vs_ptr, pos_ptr, n, KV, Tmax,
                        D: tl.constexpr, DROP: tl.constexpr):
        tok = tl.program_id(0)  # b * n + i
        h = tl.program_id(1)
        b = tok // n
        pos = tl.load(pos_ptr + b).to(tl.int64)
        if DROP:
            keep = pos < Tmax
            p = tl.minimum(pos, Tmax - 1)
        else:
            keep = pos == pos
            p = tl.minimum(tl.maximum(pos, 0), Tmax - n) + tok % n
        offs = tl.arange(0, D)
        src_off = (tok.to(tl.int64) * KV + h) * D
        dst_row = (b.to(tl.int64) * Tmax + p) * KV + h
        if tl.program_id(2) == 0:
            quantize_store(k_ptr, kd_ptr, ks_ptr, src_off, dst_row, offs, keep, D)
        else:
            quantize_store(v_ptr, vd_ptr, vs_ptr, src_off, dst_row, offs, keep, D)

    return write_kv_kernel


def write_kv_cache_cuda(k, v, k_entry: KVEntry, v_entry: KVEntry, cache_len) -> None:
    """Launch K7: k/v contiguous bf16 (B, n, KV, D) with D a power of two;
    entries contiguous int8 (B, Tmax, KV, D) and fp32 (B, Tmax, KV, 1);
    cache_len (B,) int32/int64 on the same device. One launch writes K and
    V, at the slots of `cache_write_slots` (the rule applied on the device,
    with no host synchronisation)."""
    global kv_write_launches
    B, n, KV, D = k.shape
    dev = k.device
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or tuple(t.shape) != (B, n, KV, D) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"KV write kernel: {name} must be contiguous bfloat16 "
                             f"{(B, n, KV, D)} on {dev}")
    if D & (D - 1):
        raise ValueError(f"KV write kernel: head dim {D} is not a power of two")
    Tmax = k_entry[0].shape[1]
    if n > Tmax:
        raise ValueError(f"KV write kernel: a write of {n} tokens does not fit a cache of {Tmax}")
    for name, (data, scale) in (("k", k_entry), ("v", v_entry)):
        if data.dtype != torch.int8 or tuple(data.shape) != (B, Tmax, KV, D) \
                or scale.dtype != torch.float32 or tuple(scale.shape) != (B, Tmax, KV, 1) \
                or not data.is_contiguous() or not scale.is_contiguous() \
                or data.device != dev or scale.device != dev:
            raise ValueError(f"KV write kernel: the {name} cache must be contiguous int8 "
                             f"{(B, Tmax, KV, D)} + fp32 {(B, Tmax, KV, 1)} on {dev}")
    if cache_len.device != dev or tuple(cache_len.shape) != (B,) \
            or cache_len.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"KV write kernel: cache_len must be int32/int64 ({B},) on {dev}")
    if B * n:
        with torch.cuda.device(dev):
            _write_kv_kernel()[(B * n, KV, 2)](
                k, v, k_entry[0], k_entry[1], v_entry[0], v_entry[1], cache_len.contiguous(),
                n, KV, Tmax, D=D, DROP=n == 1 and B > 1, num_warps=1)
    kv_write_launches += 1
