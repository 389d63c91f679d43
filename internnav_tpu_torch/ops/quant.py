"""int8 and int4 quantization ops of the quantized serving formats: plain
PyTorch versions and their hand-written Hopper kernels.

Ports the XLA math of internnav_tpu/model/basemodel/internvla_n1/qwen_text.py:

- `quantize_rows`: the per-token activation quantization of `QuantDense`
  (`:173-176`); kernel K6a (`csrc/quantize_rows.cu`, CUDA C++ for
  sm_90a), which also computes the op that makes its input, chosen by its
  prologue: the RMSNorm (`rmsnorm_quantize`, with the residual add before
  the post-attention norm), the SwiGLU product (`swiglu_quantize`), or
  none (`quantize_activations`).
- `w8a8_linear_reference`: its int8 x int8 product and fp32 epilogue
  (`:177-199`), per-channel or grouped scales; kernel K6b
  (`csrc/w8a8_gemm.cu`). `w8a8_linear_multi` takes several projections
  of one input (q/k/v, gate/up): at decode rows one K6b launch computes
  them all, split over the SMs by `gemm_decode_plan`.
- int4 storage (`weight_dtype="int4"`, W4A8): `pack_int4` / `unpack_int4`
  keep two signed codes in [-7, 7] a byte along K, the low nibble the even
  k, in an (N, K / 2) uint8 buffer (K contiguous, as K6b's B operand).
  `w4a8_linear_reference` is the W4A8 product (`:140-143` with `:177-196`
  at `weight_bits=4`): the codes widened to int8, then K6b's arithmetic;
  kernel K9 (`csrc/w4a8_gemm.cu`: K6b's decode ring and prefill tiles at
  4 bits; `w4a8_linear_multi` takes q/k/v or gate/up in one decode launch).
- `w8a16_linear_reference`: the `bf16_act` product (`:153-171`, the
  cached-decode projections under `decode_act_dtype="bf16"`): bf16
  activations times int8 or int4 codes widened to bf16, fp32 sums, the
  scale per channel or per group after that group's sum; kernel K10
  (`csrc/w8a16_gemm.cu`: K6b's decode ring with bf16 rows, 192 a launch;
  `w8a16_linear_multi` takes q/k/v or gate/up in one launch).
- `apply_rotary` (`:375-387`), `quantize_kv` (`:527-537`) and the quantized
  cache write of `_write_cache` / `_write_cache_chunk` (`:556-583`):
  `rope_kv_write_reference`, and without the rotary
  `write_kv_cache_reference`; kernel K7 (`csrc/rope_kv_write.cu`), which
  rotates q and k, quantizes K and V and stores them into the (B, Tmax,
  KV, D) int8 cache and its (B, Tmax, KV, 1) fp32 scales in place, in one
  launch. Where a write lands, past Tmax too, is the JAX rule
  (`cache_write_slots`), which the bf16 cache write shares.

The dispatchers (`rmsnorm_quantize`, `swiglu_quantize`,
`quantize_activations`, `w8a8_linear(_multi)`, `w4a8_linear(_multi)`,
`w8a16_linear(_multi)`, `rope_kv_write`, `write_kv_cache`)
send a CPU tensor to the plain version and a CUDA tensor to the kernel, or
raise: there is no fallback from one to the other. Each kernel wrapper adds
one to its launch count per launch. The kernels are built on the first
CUDA call, never when this module is imported.

Rounding is the JAX package's: `round` half to even (`rint` in the
kernels), and every division IEEE-rounded (the CUDA build has no fast-math
flag), so that the int8 codes match bit for bit. The RMSNorm, SiLU and
rotary steps round as the port's bf16 torch ops do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from internnav_tpu_torch.ops.activations import silu_reference
from internnav_tpu_torch.ops.rope import apply_rotary

#: launches of each kernel in this process (its CUDA wrapper adds one per
#: launch; the plain versions never do): K6a activation quantization (all
#: prologues, then each prologue's own count), K6b W8A8 GEMM, K7 rotary +
#: KV quantization + cache write, K9 W4A8 GEMM, K10 W8A16 / W4A16 GEMM;
#: each GEMM's `_fused_` count holds its launches that computed several
#: projections at once
quantize_rows_launches = 0
rmsnorm_quantize_launches = 0
swiglu_quantize_launches = 0
plain_quantize_launches = 0
w8a8_launches = 0
w8a8_fused_launches = 0
kv_write_launches = 0
w4a8_launches = 0
w4a8_fused_launches = 0
w8a16_launches = 0
w8a16_fused_launches = 0
#: the counters' names (`decode_graph` adds a captured step's launches to
#: them at every replay of its graph)
LAUNCH_COUNTERS = ("quantize_rows_launches", "rmsnorm_quantize_launches",
                   "swiglu_quantize_launches", "plain_quantize_launches", "w8a8_launches",
                   "w8a8_fused_launches", "kv_write_launches", "w4a8_launches",
                   "w4a8_fused_launches", "w8a16_launches", "w8a16_fused_launches")

#: K6a's prologues (csrc/quantize_rows.cu)
PLAIN, RMSNORM, SWIGLU = 0, 1, 2
#: K6a keeps a row in registers: at most 5 16-byte vectors a thread of
#: 1,024 threads (K <= 40,960 bf16 or 20,480 fp32)
K6A_MAX_ROW_BYTES = 1024 * 5 * 16
#: K6b takes K in 64-wide chunks; a grouped scale covers whole chunks
GEMM_K_CHUNK = 64
#: K6b's decode ring serves M <= 16, K9's M <= 64 and K10's M <= 192 (rows
#: of warps over the m-tiles above 16); above, K6b's and K9's prefill tiles
#: (K6b: 128 output rows by 256 columns where N > 1024, else 128; K9: 128 x
#: 128, 128 x 64 grouped; chosen in csrc/quant_gemm.cuh); K10 has none and
#: launches its ring once per 192 rows
GEMM_DECODE_MAX_M = 16
W4A8_MAX_M = 64
#: rows a K split over a cluster takes (rank 0 holds S x rows x 64 partials)
GEMM_SPLIT_MAX_M = 64
W8A16_MAX_M = 192
#: the decode ring (csrc/quant_gemm.cuh `DC_*`): 64 weight rows a column
#: tile, streamed in 128-byte k-lines through a ring of at most 6 stages;
#: a tile's K slices form one cluster of at most 8 blocks (the portable
#: size); up to 3 projections a launch
GEMM_DECODE_BLOCK_N = 64
GEMM_LINE = 128
GEMM_DECODE_MAX_STAGES = 6
GEMM_DECODE_MAX_SPLIT = 8
GEMM_DECODE_MAX_SEGMENTS = 3
#: the SMs of an H100 SXM, over which the plan balances the weight bytes
GEMM_SMS = 132
#: a block's fixed cost (barriers, the cluster's sum, the epilogue) in
#: weight bytes the SM could have streamed meanwhile: one stage
GEMM_DECODE_BLOCK_COST = GEMM_DECODE_BLOCK_N * GEMM_LINE
#: the plan's model of how many blocks the card holds at once: 228 KB of
#: shared memory an SM (1 KB of it reserved per block), 2,048 threads (12
#: blocks of 160), and clusters placed within GPCs, taken as 8 of 16 SMs
#: plus 4 SMs (an estimate: the card does not report its GPCs); a block may
#: take at most GEMM_BLOCK_SMEM
GEMM_SM_SMEM = 228 * 1024
GEMM_SM_THREADS = 2048
GEMM_BLOCK_SMEM = 232448
GEMM_GPCS, GEMM_GPC_SMS = 8, 16
#: weight bytes an SM keeps in flight to stream at the full rate, in the
#: plan's model: two blocks' rings of 6 stages (an estimate)
GEMM_SM_INFLIGHT = 2 * GEMM_DECODE_MAX_STAGES * GEMM_DECODE_BLOCK_N * GEMM_LINE
#: K7's head widths (one warp a row, D / 32 values a lane)
KV_WRITE_HEAD_DIMS = (64, 128, 256)
#: the largest code of each weight width (symmetric: [-qmax, qmax])
QMAX = {8: 127, 4: 7}
#: the scale group int4 weights take when none is given (JAX
#: `_effective_group`)
INT4_GROUP = 128

KVEntry = Tuple[torch.Tensor, torch.Tensor]  # (int8 data (B, T, KV, D), fp32 scale (B, T, KV, 1))


# ---------------------------------------------------------- plain versions
def div_qmax(t: torch.Tensor, bits: int) -> torch.Tensor:
    """t / QMAX[bits], IEEE-rounded on every device. The divisor is a
    tensor of t's shape: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which differs from the division in the
    last bit."""
    return t / torch.full_like(t, float(QMAX[bits]))


def effective_group(group_size: Optional[int], bits: int) -> Optional[int]:
    """The scale group a projection of `bits`-bit weights asks for: int4
    takes INT4_GROUP when none is given, int8 the caller's (JAX
    `_effective_group`). `grouped_scales` then falls back to per-channel
    where it does not divide the input width."""
    return INT4_GROUP if bits == 4 and group_size is None else group_size


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., K) in [-7, 7], K even → (..., K / 2) uint8: two
    codes a byte along K, the even k in the low nibble."""
    if codes.dtype != torch.int8 or codes.shape[-1] % 2:
        raise ValueError(f"pack_int4 takes int8 codes of even width, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    nib = codes.view(torch.uint8) & 0xF
    return nib[..., 0::2] | (nib[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K / 2) uint8 of `pack_int4` → int8 codes (..., K)."""
    if packed.dtype != torch.uint8:
        raise ValueError(f"unpack_int4 takes uint8, got {packed.dtype}")
    nib = torch.stack([packed & 0xF, packed >> 4], -1).to(torch.int16)
    return (nib - 16 * (nib >= 8)).to(torch.int8).reshape(*packed.shape[:-1], -1)


def weight_codes(weight_q: torch.Tensor) -> torch.Tensor:
    """A quantized weight's int8 codes (N, K): int8 as it is, packed int4
    (uint8 (N, K / 2)) unpacked."""
    return unpack_int4(weight_q) if weight_q.dtype == torch.uint8 else weight_q


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization over the last axis:
    a_scale = max(amax, 1e-8) / 127, q = clip(round(x / a_scale), -127, 127).
    Returns (q int8 (..., K), a_scale fp32 (..., 1))."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    a_scale = div_qmax(amax.clamp(min=1e-8), 8)
    return torch.round(xf / a_scale).clamp(-127, 127).to(torch.int8), a_scale


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The JAX package's RMSNorm of x (..., K) with an fp32 scale (K,): the
    normalised input rounded to x's dtype, times the scale in fp32."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rmsnorm_quantize_reference(x: torch.Tensor, weight: torch.Tensor, eps: float,
                               residual: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`quantize_rows` of `rms_norm` of x, or of x + residual (bf16 (..., K)).
    Returns (int8 (..., K), fp32 (..., 1), the normalised input: x +
    residual, or x)."""
    if residual is not None:
        x = x + residual
    return (*quantize_rows(rms_norm(x, weight, eps)), x)


def swiglu_quantize_reference(gate: torch.Tensor, up: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows` of the SwiGLU product of bf16 gate and up as the JAX
    package quantizes it: silu(gate) with XLA's bf16 roundings
    (`activations.silu_reference`), times up in fp32. XLA fuses the product
    into the quantization's fp32 convert, so it is not rounded to bf16."""
    return quantize_rows(silu_reference(gate).float() * up.float())


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
    xd, wd = xq.double(), weight_codes(weight_q).double()
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


def w4a8_linear_reference(xq: torch.Tensor, a_scale: torch.Tensor, weight_q: torch.Tensor,
                          scale_q: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The W4A8 product, K9's plain version: packed int4 weight_q (N, K /
    2) uint8 widened to int8 codes (JAX widens s4 to s8 for its integer
    dot, `:140-143`), then `w8a8_linear_reference`: an exact integer sum a
    scale group, the fp32 epilogue in the JAX order."""
    if weight_q.dtype != torch.uint8:
        raise ValueError(f"W4A8: weight_q must be packed int4 (uint8), got {weight_q.dtype}")
    return w8a8_linear_reference(xq, a_scale, weight_q, scale_q, bias, out_dtype)


def w8a16_linear_reference(x: torch.Tensor, weight_q: torch.Tensor, scale_q: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The `bf16_act` product of `QuantDense` (JAX `:153-171`), K10's plain
    version: x (M, K) cast to bf16, times the codes of weight_q (int8 (N,
    K) or packed int4 (N, K / 2)) widened to bf16, summed in fp32 (each
    product of two bf16 values is exact in fp32); per channel y * scale
    (N,), grouped sum_g(y_g * scale[g]) over (K / G, N) scales; then + the
    fp32 bias, cast to out_dtype. The fp32 sums run in the CPU's order,
    so the kernel agrees to fp32 rounding, not bit for bit."""
    M, K = x.shape
    w = weight_codes(weight_q)
    N = w.shape[0]
    xf = x.to(torch.bfloat16).float()
    wf = w.float()
    if scale_q.dim() == 2:
        G = scale_q.shape[0]
        g = K // G
        yg = torch.einsum("mgk,ngk->gmn", xf.view(M, G, g), wf.view(N, G, g))
        y = (yg * scale_q[:, None, :]).sum(0)
    else:
        y = (xf @ wf.T) * scale_q
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


@dataclasses.dataclass(frozen=True)
class DecodeGeometry:
    """The operand formats and block layout of a decode-ring kernel
    (csrc/quant_gemm.cuh `Format`, `launch_decode_rows`):

    - `wbits`: the code width (8, or 4 packed two a byte: a 128-byte line
      then carries 256 k); `act_bytes`: the activation bytes a k (int8 1,
      bf16 2); `max_rows`: the most rows a launch takes.
    - `fp64`: whether the sums that span units (K9's grouped terms, all of
      K10's) are added in fp64, which makes a split launch's partial words
      8 bytes (`red_bytes`).
    - `consumer_warps`: a block's consumer warps (K6b 4 of 16 columns; K9
      and K10 8, of 8 columns up to 16 rows, two rows of 4 warps of 16
      columns above), beside one producer warp.
    - `mid_blocks`, `mid_stages`: at 17 to 64 rows, the blocks an SM
      holds, fixed by registers in the kernel's launch bounds
      (`dc_min_blocks`), and the deepest ring there (0: no such rows).
    - `a_row_step`: the activation rows a stage holds, rounded up to it.
    - `max_stages`, `search_depth`: the deepest ring a plan gives, and
      whether the depth is chosen with the split (K9 and K10: their
      consumers, not the bytes in flight, set their pace, and on the H100
      a ring deeper than 3 stages only kept blocks off the SMs, in forced
      plans at the 7B shapes) or is always the deepest (K6b)."""
    name: str
    wbits: int
    act_bytes: int
    max_rows: int
    fp64: bool
    consumer_warps: int
    mid_blocks: int
    mid_stages: int
    a_row_step: int
    max_stages: int
    search_depth: bool

    @property
    def line_k(self) -> int:
        return GEMM_LINE * 8 // self.wbits

    def red_bytes(self, group: int) -> int:
        return 8 if self.fp64 and (group or self.act_bytes == 2) else 4

    def register_blocks(self, rows: int) -> int:
        """Blocks an SM holds at `rows` rows by registers where the launch
        bounds fix it (`mid_blocks`), else 0 (not modelled)."""
        return self.mid_blocks if GEMM_DECODE_MAX_M < rows <= GEMM_SPLIT_MAX_M else 0

    def deepest_ring(self, rows: int) -> int:
        """The most stages a plan at `rows` rows may give a block."""
        return self.mid_stages if self.register_blocks(rows) else self.max_stages


#: K6b (int8 rows x int8 codes), K9 (int8 rows x int4 codes), K10 (bf16
#: rows x int8 or int4 codes)
#: (at 17 to 64 rows two blocks of K9 or K10 share an SM, and their rings
#: go 2 deep: on the H100 a third stage gained nothing at the 7B shapes
#: with int8 codes and cost K10's int4 gate/up at 48 rows 13%)
K6B_GEOMETRY = DecodeGeometry("K6b", 8, 1, GEMM_DECODE_MAX_M, False, 4, 0, 0, 16,
                              GEMM_DECODE_MAX_STAGES, False)
K9_GEOMETRY = DecodeGeometry("K9", 4, 1, W4A8_MAX_M, True, 8, 2, 2, 8, 3, True)
K10_GEOMETRY = {bits: DecodeGeometry("K10", bits, 2, W8A16_MAX_M, True, 8, 2, 2, 8, 3, True)
                for bits in (8, 4)}


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How a decode-ring launch (K6b, K9 or K10: `geometry`) splits: column
    tiles of `block_n` weight rows over each segment (projection), in
    `tile_order`, each tile's K in `split` slices of whole units of
    `unit_lines` 128-byte weight lines (whole scale groups when grouped),
    `stages` ring stages a block, `grid` blocks. With split > 1 a tile is
    one cluster of `split` blocks, block tile * split + rank; with split 1
    block b walks tiles b, b + grid, ... (`units`)."""
    segments: Tuple[int, ...]  # N of each segment
    K: int
    group: int  # 0: per-channel scales
    block_n: int
    split: int
    unit_lines: int
    stages: int = 1
    grid: int = 0
    geometry: DecodeGeometry = K6B_GEOMETRY

    @property
    def lines(self) -> int:
        return -(-self.K // self.geometry.line_k)

    @property
    def tiles(self) -> int:
        return sum(-(-n // self.block_n) for n in self.segments)

    def slice_lines(self, rank: int) -> Tuple[int, int]:
        """Lines [l0, l1) of K slice `rank`: the kernel's rule."""
        units = -(-self.lines // self.unit_lines)
        l0 = min(self.lines, rank * units // self.split * self.unit_lines)
        l1 = min(self.lines, (rank + 1) * units // self.split * self.unit_lines)
        return l0, l1

    def tile_order(self) -> List[Tuple[int, int]]:
        """The column tiles as (segment, first column) in the kernel's order
        (csrc/quant_gemm.cuh `dc_segment`): every segment's full-width tiles
        in segment order, then the narrow edge tiles of the ragged widths.
        Dealt round the SMs, the edge tiles land on the last SMs served, the
        ones that take an extra tile."""
        bn = self.block_n
        full = [(seg, n0) for seg, N in enumerate(self.segments)
                for n0 in range(0, N // bn * bn, bn)]
        return full + [(seg, N // bn * bn) for seg, N in enumerate(self.segments) if N % bn]

    def units(self) -> Iterator[Tuple[int, int, int, int, int, int]]:
        """Every block's work: (block, segment, first column, end column,
        first k, end k), columns and k clipped to the matrix."""
        for tile, (seg, n0) in enumerate(self.tile_order()):
            N = self.segments[seg]
            for rank in range(self.split):
                l0, l1 = self.slice_lines(rank)
                block = tile * self.split + rank if self.split > 1 else tile % self.grid
                line_k = self.geometry.line_k
                yield (block, seg, n0, min(N, n0 + self.block_n),
                       min(self.K, l0 * line_k), min(self.K, l1 * line_k))

    def unit_bytes(self, c0: int, c1: int, k0: int, k1: int) -> int:
        """The weight bytes of columns [c0, c1) over k [k0, k1)."""
        return (c1 - c0) * (k1 - k0) * self.geometry.wbits // 8

    def smem_bytes(self, rows: int) -> int:
        """A block's dynamic shared memory at `rows` rows (csrc/quant_gemm.cuh
        `dc_smem_bytes`): the ring (a stage: 64 weight rows, the activation
        rows (K6b 16, or `rows` rounded up to 16 above; K9 and K10 `rows`
        rounded up to 8), padded by 16 bytes, and with
        grouped scales a 64-column scale row for each 64-k chunk), rank 0's
        S x rows x 64 partial words (split launches) and the barriers."""
        geo = self.geometry
        a_rows = -(-rows // geo.a_row_step) * geo.a_row_step
        scales = geo.line_k // GEMM_K_CHUNK * self.block_n * 4 if self.group else 0
        return (1024 + self.stages * (self.block_n * GEMM_LINE
                                      + a_rows * (geo.line_k * geo.act_bytes + 16) + scales)
                + (self.split * rows * self.block_n * geo.red_bytes(self.group)
                   if self.split > 1 else 0)
                + (2 * GEMM_DECODE_MAX_STAGES + 1) * 8)

    def resident_blocks(self, rows: int) -> int:
        """Blocks the card holds at once in the plan's model (GEMM_SM_SMEM,
        GEMM_SM_THREADS, GEMM_GPCS, GEMM_GPC_SMS, and the registers where
        the geometry's launch bounds fix them): whole clusters of `split`
        within a GPC."""
        geo = self.geometry
        threads = 32 * (geo.consumer_warps + 1)
        per_sm = min(GEMM_SM_THREADS // threads, GEMM_SM_SMEM // (self.smem_bytes(rows) + 1024))
        if geo.register_blocks(rows):
            per_sm = min(per_sm, geo.register_blocks(rows))
        rest = GEMM_SMS - GEMM_GPCS * GEMM_GPC_SMS
        clusters = (GEMM_GPCS * (GEMM_GPC_SMS * per_sm // self.split)
                    + rest * per_sm // self.split)
        return clusters * self.split

    def sm_bytes(self, sms: int = GEMM_SMS, block_cost: int = 0) -> List[int]:
        """Weight bytes each SM streams when block b runs on SM b % sms
        (the launch order dealt round the SMs), plus `block_cost` a block
        (a split launch's; a whole-K block pays it once)."""
        load = [0] * sms
        for block, _, c0, c1, k0, k1 in self.units():
            load[block % sms] += self.unit_bytes(c0, c1, k0, k1)
        for block in range(self.grid):
            load[block % sms] += block_cost
        return load

    def model_time(self, rows: int) -> float:
        """The plan's cost in the model: the busiest SM's bytes (with
        GEMM_DECODE_BLOCK_COST a block) over its rate, the full rate where
        its resident blocks keep GEMM_SM_INFLIGHT bytes in flight, else in
        proportion."""
        load = self.sm_bytes(block_cost=GEMM_DECODE_BLOCK_COST)
        per_sm = max(1, self.resident_blocks(rows) // GEMM_SMS)
        ring = self.stages * self.block_n * GEMM_LINE
        time = 0.0
        for sm, nbytes in enumerate(load):
            blocks = len(range(sm, self.grid, GEMM_SMS))
            if blocks:
                rate = min(1.0, min(blocks, per_sm) * ring / GEMM_SM_INFLIGHT)
                time = max(time, nbytes / rate)
        return time


def _decode_plan_fair(plan: DecodePlan) -> bool:
    """No SM streams more than one tile's bytes above the mean: a block's
    share of one column tile (one K slice) where split > 1, a whole tile
    where split is 1.

    Split 1 always passes. Tile i runs on SM i % GEMM_SMS (the grid is the
    tiles or a multiple of the SMs), so with T = q * GEMM_SMS + r tiles the
    SMs that take q + 1 are the ones of the last r tiles, where
    `tile_order` puts the e <= 3 edge tiles, short of full width by D <
    64 e columns in all. Where r > e the busiest SM holds q + 1 full tiles,
    (64 - (64 r - D) / GEMM_SMS) K bytes above the mean, under a tile; where
    1 <= r <= e it holds one edge tile short by d >= 1 columns, 64 - d + (D
    - 64 r) / GEMM_SMS <= 64 above it; where r = 0 it is D / GEMM_SMS
    above."""
    load = plan.sm_bytes()
    biggest = max(plan.unit_bytes(c0, c1, k0, k1) for _, _, c0, c1, k0, k1 in plan.units())
    return max(load) - sum(load) / len(load) <= biggest


@functools.lru_cache(maxsize=None)
def gemm_decode_plan(segments: Tuple[int, ...], K: int, group: int = 0,
                     rows: int = GEMM_DECODE_MAX_M,
                     geometry: DecodeGeometry = K6B_GEOMETRY) -> DecodePlan:
    """The decode-ring plan of `geometry` (K6b by default; K9, K10) for
    projections of widths `segments` of one (rows, K) input, with scale
    groups of `group` inputs (0: per-channel): the K split (1 to
    GEMM_DECODE_MAX_SPLIT, never inside a scale group, only 1 above
    GEMM_SPLIT_MAX_M rows)
    of the least `model_time`, among the splits that give no SM more than
    one block's bytes above the mean (`_decode_plan_fair`; split 1 always
    does), and of those the ones whose blocks the card holds at once
    (`resident_blocks`) where there are any; on a tie the one whose busiest
    SM streams fewer weight bytes, then the smaller split, then the deeper
    ring. K6b's ring gets as many stages as a block's slice has lines, at
    most its geometry's `max_stages`; K9's and K10's depth, up to their
    `deepest_ring(rows)`, is chosen with the split (`search_depth`); a
    block's shared memory stays within GEMM_BLOCK_SMEM. Without a split the
    grid is the tiles, at most the blocks the card holds at once (each then
    walks several tiles)."""
    segments = tuple(int(n) for n in segments)
    if not 1 <= len(segments) <= GEMM_DECODE_MAX_SEGMENTS or min(segments) < 1:
        raise ValueError(f"{geometry.name} decodes 1 to {GEMM_DECODE_MAX_SEGMENTS} projections "
                         f"of positive width, got {segments}")
    if K < 1 or K % GEMM_K_CHUNK or group % GEMM_K_CHUNK:
        raise ValueError(f"{geometry.name}: K={K} and the group {group} must be multiples of "
                         f"{GEMM_K_CHUNK}")
    if not 1 <= rows <= geometry.max_rows:
        raise ValueError(f"{geometry.name}'s decode ring takes 1 to {geometry.max_rows} rows, "
                         f"got {rows}")
    line_k = geometry.line_k
    unit_lines = group // math.gcd(group, line_k) if group else 1  # lcm(group, line) / line
    lines = -(-K // line_k)
    units = -(-lines // unit_lines)
    splits = min(GEMM_DECODE_MAX_SPLIT, units) if rows <= GEMM_SPLIT_MAX_M else 1
    candidates = []
    for split in range(1, splits + 1):
        plan = DecodePlan(segments, K, group, GEMM_DECODE_BLOCK_N, split, unit_lines,
                          geometry=geometry)
        most = max(l1 - l0 for l0, l1 in map(plan.slice_lines, range(split)))
        deepest = min(geometry.deepest_ring(rows), most)
        # K6b's ring is as deep as it may be; K9's and K10's depth is chosen
        # with the split (a shallower ring lets more blocks share an SM)
        for stages in range(deepest, 0 if geometry.search_depth else deepest - 1, -1):
            plan = dataclasses.replace(plan, stages=stages, grid=0)
            if plan.smem_bytes(rows) > GEMM_BLOCK_SMEM:
                continue
            resident = plan.resident_blocks(rows)
            plan = dataclasses.replace(plan, grid=plan.tiles * split if split > 1
                                       else min(plan.tiles, resident))
            if not _decode_plan_fair(plan):
                continue
            cost = (plan.model_time(rows), max(plan.sm_bytes()), -stages)
            candidates.append((plan.grid > resident, cost, plan))
    fits = [c for c in candidates if not c[0]] or candidates
    return min(fits, key=lambda c: c[1])[2]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over head_dim: x (..., D) → (int8
    (..., D), fp32 scale (..., 1)) with scale = max(amax / 127, 1e-8) (not
    the activation scale's expression: the clamp comes after the
    division)."""
    xf = x.float()
    s = div_qmax(xf.abs().amax(-1, keepdim=True), 8).clamp(min=1e-8)
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


def rope_kv_write_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor, k_entry: KVEntry,
                            v_entry: KVEntry, cache_len: torch.Tensor) -> torch.Tensor:
    """`apply_rotary` of q (B n, H D) and k (B n, KV D) at cos/sin (B, n,
    D), then `write_kv_cache_reference` of the rotated k and of v (B n, KV
    D) at cache_len (B,), in place. Returns the rotated q (B, H, n, D)."""
    B, n, D = cos.shape
    KV = k_entry[0].shape[2]
    q_rot, k_rot = apply_rotary(q.reshape(B, n, -1, D).transpose(1, 2),
                                k.reshape(B, n, KV, D).transpose(1, 2), cos, sin)
    write_kv_cache_reference(k_rot.transpose(1, 2), v.reshape(B, n, KV, D), k_entry, v_entry,
                             cache_len)
    return q_rot


# ------------------------------------------------------------ dispatchers
def rmsnorm_quantize(x, weight, eps: float, residual=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`rmsnorm_quantize_reference` of bf16 rows x (..., K), or of x +
    residual, with an fp32 scale (K,): the plain version on the CPU, K6a's
    RMSNORM prologue on CUDA. Returns (int8 (..., K), fp32 (..., 1), x +
    residual or x)."""
    if x.is_cuda:
        return rmsnorm_quantize_cuda(x.contiguous(), weight, eps,
                                     None if residual is None else residual.contiguous())
    _require_cpu(x, "rmsnorm_quantize")
    return rmsnorm_quantize_reference(x, weight, eps, residual)


def swiglu_quantize(gate, up) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows` of silu(gate) * up (bf16 (..., K)): the plain version
    on the CPU, K6a's SWIGLU prologue on CUDA."""
    if gate.is_cuda:
        return swiglu_quantize_cuda(gate.contiguous(), up.contiguous())
    _require_cpu(gate, "swiglu_quantize")
    return swiglu_quantize_reference(gate, up)


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows` of (..., K) rows: the plain version on the CPU, K6a's
    PLAIN prologue on CUDA (bf16 or fp32)."""
    if x.is_cuda:
        return quantize_rows_cuda(x.contiguous())
    _require_cpu(x, "quantize_activations")
    return quantize_rows(x)


def w8a8_linear(xq, a_scale, weight_q, scale_q, bias=None, *,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The W8A8 product: plain version on the CPU, K6b on CUDA (bf16 out).
    scale_q (N,) is per-channel, (G, N) grouped over K / G inputs."""
    return w8a8_linear_multi(xq, a_scale, [(weight_q, scale_q, bias)], out_dtype=out_dtype)[0]


def w8a8_linear_multi(xq, a_scale, segments: Sequence[Tuple], *,
                      out_dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
    """The W8A8 products of one input xq (M, K) int8, a_scale (M, 1) with
    each (weight_q (N_i, K), scale_q, bias) of `segments` (1 to 3; all
    per-channel or all grouped alike): one (M, N_i) output each. On the
    CPU each segment's plain version; on CUDA at M <= 16 one launch of K6b's
    decode tiles for all of them, above one launch of its prefill tiles a
    segment."""
    if xq.is_cuda:
        if out_dtype != torch.bfloat16:
            raise TypeError(f"W8A8 kernel writes bfloat16, not {out_dtype}")
        if xq.shape[0] <= GEMM_DECODE_MAX_M:
            return w8a8_decode_cuda(xq, a_scale, segments)
        return [w8a8_linear_cuda(xq, a_scale, *seg) for seg in segments]
    _require_cpu(xq, "w8a8_linear")
    return [w8a8_linear_reference(xq, a_scale, w, s, b, out_dtype=out_dtype)
            for w, s, b in segments]


def w4a8_linear(xq, a_scale, weight_q, scale_q, bias=None, *,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The W4A8 product of xq (M, K) int8, a_scale (M, 1) and packed int4
    weight_q (N, K / 2): the plain version on the CPU, K9 on CUDA (bf16
    out)."""
    return w4a8_linear_multi(xq, a_scale, [(weight_q, scale_q, bias)], out_dtype=out_dtype)[0]


def w4a8_linear_multi(xq, a_scale, segments: Sequence[Tuple], *,
                      out_dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
    """The W4A8 products of one input xq (M, K) int8, a_scale (M, 1) with
    each (packed int4 weight_q (N_i, K / 2), scale_q, bias) of `segments`
    (1 to 3; all per-channel or all grouped alike). On the CPU each
    segment's plain version; on CUDA at M <= W4A8_MAX_M one launch of K9's
    decode ring for all of them, above one launch of its prefill tiles a
    segment."""
    if xq.is_cuda:
        if out_dtype != torch.bfloat16:
            raise TypeError(f"W4A8 kernel writes bfloat16, not {out_dtype}")
        if xq.shape[0] <= W4A8_MAX_M:
            return w4a8_decode_cuda(xq, a_scale, segments)
        return [w4a8_linear_cuda(xq, a_scale, *seg) for seg in segments]
    _require_cpu(xq, "w4a8_linear")
    return [w4a8_linear_reference(xq, a_scale, w, s, b, out_dtype) for w, s, b in segments]


def w8a16_linear(x, weight_q, scale_q, bias=None, *,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The W8A16 / W4A16 product of x (M, K) (cast to bf16) and int8 (N, K)
    or packed int4 (N, K / 2) codes: the plain version on the CPU, K10 on
    CUDA (bf16 out)."""
    return w8a16_linear_multi(x, [(weight_q, scale_q, bias)], out_dtype=out_dtype)[0]


def w8a16_linear_multi(x, segments: Sequence[Tuple], *,
                       out_dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
    """The W8A16 / W4A16 products of one input x (M, K) (cast to bf16) with
    each (weight_q, scale_q, bias) of `segments` (1 to 3, all int8 or all
    packed int4 codes, all per-channel or all grouped alike). On the CPU
    each segment's plain version; on CUDA one launch of K10 for all of
    them, per W8A16_MAX_M rows."""
    if x.is_cuda:
        if out_dtype != torch.bfloat16:
            raise TypeError(f"W8A16 kernel writes bfloat16, not {out_dtype}")
        return w8a16_decode_cuda(x.to(torch.bfloat16).contiguous(), segments)
    _require_cpu(x, "w8a16_linear")
    return [w8a16_linear_reference(x, w, s, b, out_dtype) for w, s, b in segments]


def rope_kv_write(q, k, v, cos, sin, k_entry: KVEntry, v_entry: KVEntry, cache_len
                  ) -> torch.Tensor:
    """Rotate q (B n, H D) and k (B n, KV D) at cos/sin (B, n, D), quantize
    k and v (B n, KV D) into the int8 cache at cache_len (B,) in place, and
    return the rotated q (B, H, n, D): the plain version on the CPU, K7 on
    CUDA. q/k/v may carry their leading dims as (B, n, width)."""
    if q.is_cuda:
        return rope_kv_write_cuda(*(t.reshape(-1, t.shape[-1]).contiguous() for t in (q, k, v)),
                                  cos.contiguous(), sin.contiguous(), k_entry, v_entry,
                                  cache_len)
    _require_cpu(q, "rope_kv_write")
    return rope_kv_write_reference(q, k, v, cos, sin, k_entry, v_entry, cache_len)


def write_kv_cache(k, v, k_entry: KVEntry, v_entry: KVEntry, cache_len) -> None:
    """Quantize k/v (B, n, KV, D) into the int8 cache at cache_len (B,), in
    place, without rotary: the plain version on the CPU, K7 on CUDA."""
    if k.is_cuda:
        write_kv_cache_cuda(k.contiguous(), v.contiguous(), k_entry, v_entry, cache_len)
        return
    _require_cpu(k, "write_kv_cache")
    write_kv_cache_reference(k, v, k_entry, v_entry, cache_len)


def _require_cpu(t, name):
    if t.device.type != "cpu":
        raise ValueError(f"{name} has no path for device {t.device}")


def _check_cuda(name, t, dtype, shape, device, kernel="W8A8 kernel"):
    if t.dtype != dtype or t.shape != tuple(shape) or t.device != device \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must be a contiguous, 16-byte aligned {dtype} "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _stream(device) -> int:
    """The current stream of a CUDA device, by its index (a device object
    takes PyTorch's slower lookup on every launch). Under CUDA graph
    capture this is the capturing stream, so every launch wrapper of this
    module is capture-safe: it launches on this stream, reads no tensor
    on the host and takes its plan from shapes alone."""
    return torch.cuda.current_stream(device.index).cuda_stream


# --------------------------------------------------------- K6a (CUDA C++)
@functools.lru_cache(maxsize=None)
def _quantize_rows_entry():
    """K6a's C entry point, built and bound once per process."""
    from internnav_tpu_torch.ops._build import load_library

    fn = load_library("quantize_rows.cu").quantize_rows
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _quantize_rows_launch(prologue: int, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                          weight: Optional[torch.Tensor] = None, eps: float = 0.0):
    """Launch K6a with `prologue` on contiguous (..., K) CUDA rows a (bf16;
    fp32 too for PLAIN) and b (the RMSNORM residual or SWIGLU's up, bf16),
    weight the RMSNORM scale (K,) fp32. Returns (int8 (..., K), fp32 (...,
    1), x + residual bf16 (..., K) or None). Raises on anything else."""
    global quantize_rows_launches, rmsnorm_quantize_launches, swiglu_quantize_launches, \
        plain_quantize_launches
    kernel = "activation quantization kernel"
    dtypes = (torch.bfloat16, torch.float32) if prologue == PLAIN else (torch.bfloat16,)
    if not a.is_cuda or a.dtype not in dtypes or a.dim() < 1:
        raise ValueError(f"{kernel}: the input must be a {' or '.join(map(str, dtypes))} "
                         f"(..., K) CUDA tensor, got {a.dtype} {tuple(a.shape)} on {a.device}")
    dev, K = a.device, a.shape[-1]
    _check_cuda("the input", a, a.dtype, a.shape, dev, kernel)
    if K == 0 or (K * a.element_size()) % 16 or K * a.element_size() > K6A_MAX_ROW_BYTES:
        raise ValueError(f"{kernel}: a row of K={K} {a.dtype} must be a positive multiple of 16 "
                         f"bytes and at most {K6A_MAX_ROW_BYTES}")
    if b is not None:
        _check_cuda("the second input", b, torch.bfloat16, a.shape, dev, kernel)
    if weight is not None:
        _check_cuda("the norm scale", weight, torch.float32, (K,), dev, kernel)
    M = a.numel() // K
    q = torch.empty(a.shape, dtype=torch.int8, device=dev)
    s = torch.empty((*a.shape[:-1], 1), dtype=torch.float32, device=dev)
    xs = torch.empty_like(a) if prologue == RMSNORM and b is not None else None
    if M:
        with torch.cuda.device(dev.index):
            err = _quantize_rows_entry()(
                prologue, int(a.dtype == torch.float32), a.data_ptr(),
                None if b is None else b.data_ptr(),
                None if weight is None else weight.data_ptr(), float(eps), q.data_ptr(),
                s.data_ptr(), None if xs is None else xs.data_ptr(), M, K, _stream(dev))
        if err != 0:
            raise RuntimeError(f"activation quantization kernel launch failed: cudaError_t {err}")
        quantize_rows_launches += 1
        if prologue == RMSNORM:
            rmsnorm_quantize_launches += 1
        elif prologue == SWIGLU:
            swiglu_quantize_launches += 1
        else:
            plain_quantize_launches += 1
    return q, s, xs


def quantize_rows_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a's PLAIN prologue on contiguous bf16 or fp32 (..., K) CUDA rows
    (the attention output; the final norm's fp32 product for the lm_head):
    returns (int8 (..., K), fp32 (..., 1))."""
    return _quantize_rows_launch(PLAIN, x)[:2]


def rmsnorm_quantize_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float,
                          residual: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6a's RMSNORM prologue: x (and residual) contiguous bf16 (..., K),
    weight fp32 (K,). Returns (int8 (..., K), fp32 (..., 1), x + residual
    (written by the kernel) or x)."""
    q, s, xs = _quantize_rows_launch(RMSNORM, x, residual, weight, eps)
    return q, s, x if xs is None else xs


def swiglu_quantize_cuda(gate: torch.Tensor, up: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a's SWIGLU prologue: gate and up contiguous bf16 (..., K)."""
    return _quantize_rows_launch(SWIGLU, gate, up)[:2]


# --------------------------------------------------------- K6b (CUDA C++)
@functools.lru_cache(maxsize=None)
def _gemm_entries():
    """K6b's C entry points (prefill tiles, decode tiles), built and bound
    once per process."""
    from internnav_tpu_torch.ops._build import load_library

    lib = load_library("w8a8_gemm.cu")
    prefill, decode = lib.w8a8_gemm_prefill, lib.w8a8_gemm_decode
    prefill.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    decode.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                       + ([ctypes.c_void_p] * 4 + [ctypes.c_int]) * GEMM_DECODE_MAX_SEGMENTS
                       + [ctypes.c_void_p])
    prefill.restype = decode.restype = ctypes.c_int
    return prefill, decode


def _check_gemm_input(xq, a_scale, kernel: str = "W8A8 kernel", name: str = "xq",
                      dtype: torch.dtype = torch.int8) -> Tuple[int, int]:
    """(M, K) of a GEMM's 2-d CUDA input `name` of `dtype`, K a multiple of
    64, with its (M, 1) fp32 row scales where it has them."""
    if not xq.is_cuda or xq.dim() != 2:
        raise ValueError(f"{kernel}: {name} must be a 2-d CUDA tensor")
    M, K = xq.shape
    if K % GEMM_K_CHUNK:
        raise ValueError(f"{kernel}: K={K} is not a multiple of {GEMM_K_CHUNK}")
    _check_cuda(name, xq, dtype, (M, K), xq.device, kernel)
    if a_scale is not None:
        _check_cuda("a_scale", a_scale, torch.float32, (M, 1), xq.device, kernel)
    return M, K


def _check_gemm_weight(weight_q, scale_q, bias, K: int, device, bits: int = 8,
                       kernel: str = "W8A8 kernel") -> Tuple[int, int]:
    """(N, group) of one projection, group 0 for per-channel scales: an
    int8 (N, K) weight, or at 4 bits a packed uint8 (N, K / 2) one."""
    if weight_q.dim() != 2:
        raise ValueError(f"{kernel}: weight_q must be 2-d, got {tuple(weight_q.shape)}")
    N = weight_q.shape[0]
    if bits == 4:
        _check_cuda("weight_q", weight_q, torch.uint8, (N, K // 2), device, kernel)
    else:
        _check_cuda("weight_q", weight_q, torch.int8, (N, K), device, kernel)
    group = 0
    if scale_q.dim() == 2:
        G = scale_q.shape[0]
        group = K // G if G and K % G == 0 else 0
        if not group or group % GEMM_K_CHUNK:
            raise ValueError(f"{kernel}: {G} scale groups over K={K} are not whole "
                             f"{GEMM_K_CHUNK}-wide chunks")
    _check_cuda("scale_q", scale_q, torch.float32, (K // group, N) if group else (N,), device,
                kernel)
    if bias is not None:
        _check_cuda("bias", bias, torch.float32, (N,), device, kernel)
    return N, group


def w8a8_linear_cuda(xq, a_scale, weight_q, scale_q, bias=None) -> torch.Tensor:
    """Launch K6b: xq (M, K) int8, a_scale (M, 1) fp32, weight_q (N, K)
    int8 (K contiguous), scale_q (N,) or (G, N) fp32, bias (N,) fp32 or
    None → bf16 (M, N): the decode tiles at M <= 16, else the prefill
    tiles. K must be a multiple of 64, a group a multiple of 64. Raises on
    anything else."""
    global w8a8_launches
    M, K = _check_gemm_input(xq, a_scale)
    if M <= GEMM_DECODE_MAX_M:
        return _decode_launch(xq, a_scale, M, K, [(weight_q, scale_q, bias)])[0]
    dev = xq.device
    N, group = _check_gemm_weight(weight_q, scale_q, bias, K, dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev.index):
        err = _gemm_entries()[0](xq.data_ptr(), a_scale.data_ptr(), weight_q.data_ptr(),
                                 scale_q.data_ptr(), None if bias is None else bias.data_ptr(),
                                 out.data_ptr(), M, N, K, group, _stream(dev))
    if err != 0:
        raise RuntimeError(f"W8A8 kernel launch failed: cudaError_t {err}")
    w8a8_launches += 1
    return out


def w8a8_decode_cuda(xq, a_scale, segments: Sequence[Tuple]) -> List[torch.Tensor]:
    """Launch K6b's decode tiles once for 1 to 3 projections of xq (M <=
    16, K) int8 and a_scale (M, 1) fp32: segments of (weight_q (N_i, K)
    int8, scale_q (N_i,) or (G, N_i) fp32, bias (N_i,) fp32 or None), all
    per-channel or all with the same group. Returns bf16 (M, N_i) each,
    split over the card by `gemm_decode_plan`. Raises on anything else."""
    return _decode_launch(xq, a_scale, *_check_gemm_input(xq, a_scale), segments)


def _decode_launch(xq, a_scale, M: int, K: int, segments: Sequence[Tuple]
                   ) -> List[torch.Tensor]:
    """`w8a8_decode_cuda` on checked xq (M, K) and a_scale."""
    global w8a8_launches, w8a8_fused_launches
    outs = _ring_launch(K6B_GEOMETRY, "W8A8 decode tiles", _gemm_entries()[1], xq, a_scale,
                        M, K, segments)
    if M:
        w8a8_launches += 1
        w8a8_fused_launches += len(segments) > 1
    return outs


def _ring_launch(geometry: DecodeGeometry, kernel: str, entry, x, a_scale, M: int, K: int,
                 segments: Sequence[Tuple], outs: Optional[List[torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
    """One decode-ring launch of `geometry` (K6b, K9 or K10; `entry` its C
    function) over x (M, K) (int8 with a_scale (M, 1), or bf16 with
    a_scale None) and 1 to 3 segments of (weight_q, scale_q, bias) sharing
    one scale group, checked here; returns the bf16 (M, N_i) outputs,
    written into `outs` where given (contiguous, as allocated here).
    Raises on anything the kernel does not take."""
    if M > geometry.max_rows:
        raise ValueError(f"{kernel} take M <= {geometry.max_rows} rows, got {M}")
    if not 1 <= len(segments) <= GEMM_DECODE_MAX_SEGMENTS:
        raise ValueError(f"{kernel} take 1 to {GEMM_DECODE_MAX_SEGMENTS} projections, "
                         f"got {len(segments)}")
    dev = x.device
    shapes = [_check_gemm_weight(*seg, K, dev, geometry.wbits, kernel) for seg in segments]
    group = shapes[0][1]
    if any(g != group for _, g in shapes):
        raise ValueError(f"{kernel}: the projections' scale groups differ: {shapes}")
    if outs is None:
        outs = [torch.empty((M, N), dtype=torch.bfloat16, device=dev) for N, _ in shapes]
    if not M:
        return outs
    plan = gemm_decode_plan(tuple(N for N, _ in shapes), K, group, M, geometry)
    args = []
    for i in range(GEMM_DECODE_MAX_SEGMENTS):
        if i < len(segments):
            w, s, b = segments[i]
            args += [w.data_ptr(), s.data_ptr(), None if b is None else b.data_ptr(),
                     outs[i].data_ptr(), shapes[i][0]]
        else:
            args += [None, None, None, None, 0]
    # the tensor maps of the weights are cached by pointer in the library
    # and passed as __grid_constant__ parameters: a captured launch keeps
    # the maps it was given, right as long as the weights stay where they
    # are (module buffers, never moved while a graph lives)
    head = ([x.data_ptr(), a_scale.data_ptr(), M, K, group] if a_scale is not None
            else [x.data_ptr(), M, K, group, geometry.wbits])
    with torch.cuda.device(dev.index):
        err = entry(*head, len(segments), plan.block_n, plan.split, plan.unit_lines,
                    plan.stages, plan.grid, *args, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
    return outs


# ------------------------------------------------------ K9, K10 (CUDA C++)
@functools.lru_cache(maxsize=None)
def _w4a8_entries():
    """K9's C entry points (prefill tiles, decode ring), built and bound
    once per process."""
    from internnav_tpu_torch.ops._build import load_library

    lib = load_library("w4a8_gemm.cu")
    prefill, decode = lib.w4a8_gemm_prefill, lib.w4a8_gemm_decode
    prefill.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    decode.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                       + ([ctypes.c_void_p] * 4 + [ctypes.c_int]) * GEMM_DECODE_MAX_SEGMENTS
                       + [ctypes.c_void_p])
    prefill.restype = decode.restype = ctypes.c_int
    return prefill, decode


@functools.lru_cache(maxsize=None)
def _w8a16_entry():
    """K10's C entry point, built and bound once per process."""
    from internnav_tpu_torch.ops._build import load_library

    fn = load_library("w8a16_gemm.cu").w8a16_gemm_decode
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 10
                   + ([ctypes.c_void_p] * 4 + [ctypes.c_int]) * GEMM_DECODE_MAX_SEGMENTS
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def w4a8_linear_cuda(xq, a_scale, weight_q, scale_q, bias=None) -> torch.Tensor:
    """Launch K9: xq (M, K) int8, a_scale (M, 1) fp32, weight_q (N, K / 2)
    packed int4 (`pack_int4`), scale_q (N,) or (G, N) fp32, bias (N,) fp32
    or None → bf16 (M, N): the decode ring at M <= W4A8_MAX_M, else the
    prefill tiles. K must be a multiple of 64, a group a multiple of 64.
    Raises on anything else."""
    global w4a8_launches
    kernel = "W4A8 kernel"
    M, K = _check_gemm_input(xq, a_scale, kernel)
    if M <= W4A8_MAX_M:
        return w4a8_decode_cuda(xq, a_scale, [(weight_q, scale_q, bias)])[0]
    dev = xq.device
    N, group = _check_gemm_weight(weight_q, scale_q, bias, K, dev, 4, kernel)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev.index):
        err = _w4a8_entries()[0](xq.data_ptr(), a_scale.data_ptr(), weight_q.data_ptr(),
                                 scale_q.data_ptr(), None if bias is None else bias.data_ptr(),
                                 out.data_ptr(), M, N, K, group, _stream(dev))
    if err != 0:
        raise RuntimeError(f"W4A8 kernel launch failed: cudaError_t {err}")
    w4a8_launches += 1
    return out


def w4a8_decode_cuda(xq, a_scale, segments: Sequence[Tuple]) -> List[torch.Tensor]:
    """Launch K9's decode ring once for 1 to 3 projections of xq (M <= 64,
    K) int8 and a_scale (M, 1) fp32: segments of (weight_q (N_i, K / 2)
    packed int4, scale_q (N_i,) or (G, N_i) fp32, bias (N_i,) fp32 or
    None), all per-channel or all with the same group. Returns bf16 (M,
    N_i) each, split over the card by `gemm_decode_plan` at K9's geometry.
    Raises on anything else."""
    global w4a8_launches, w4a8_fused_launches
    kernel = "W4A8 decode ring"
    M, K = _check_gemm_input(xq, a_scale, kernel)
    outs = _ring_launch(K9_GEOMETRY, kernel, _w4a8_entries()[1], xq, a_scale, M, K, segments)
    if M:
        w4a8_launches += 1
        w4a8_fused_launches += len(segments) > 1
    return outs


def w8a16_linear_cuda(x, weight_q, scale_q, bias=None) -> torch.Tensor:
    """Launch K10: x (M, K) bf16, weight_q int8 (N, K) or packed int4 (N, K
    / 2) uint8, scale_q (N,) or (G, N) fp32, bias (N,) fp32 or None → bf16
    (M, N), one launch per W8A16_MAX_M rows. K must be a multiple of 64, a
    group a multiple of 64. Raises on anything else."""
    return w8a16_decode_cuda(x, [(weight_q, scale_q, bias)])[0]


def w8a16_decode_cuda(x, segments: Sequence[Tuple]) -> List[torch.Tensor]:
    """Launch K10 for 1 to 3 projections of x (M, K) bf16: segments of
    (weight_q, scale_q, bias), all int8 (N_i, K) or all packed int4 (N_i,
    K / 2) codes, all per-channel or all with the same group. One launch
    (counted) per W8A16_MAX_M rows, each writing its rows of the outputs:
    a row's bits do not depend on the rows launched with it. Returns bf16
    (M, N_i) each, split over the card by `gemm_decode_plan` at K10's
    geometry. Raises on anything else."""
    global w8a16_launches, w8a16_fused_launches
    kernel = "W8A16 kernel"
    M, K = _check_gemm_input(x, None, kernel, "x", torch.bfloat16)
    kinds = {w.dtype for w, _, _ in segments}
    if len(kinds) != 1 or not kinds <= {torch.int8, torch.uint8}:
        raise ValueError(f"{kernel}: the codes must be all int8 or all packed int4 (uint8), "
                         f"got {sorted(map(str, kinds))}")
    geometry = K10_GEOMETRY[4 if kinds == {torch.uint8} else 8]
    if M <= geometry.max_rows:
        outs = _ring_launch(geometry, kernel, _w8a16_entry(), x, None, M, K, segments)
    else:
        outs = [torch.empty((M, w.shape[0]), dtype=torch.bfloat16, device=x.device)
                for w, _, _ in segments]
        for m0 in range(0, M, geometry.max_rows):
            rows = slice(m0, m0 + geometry.max_rows)
            _ring_launch(geometry, kernel, _w8a16_entry(), x[rows], None,
                         min(M - m0, geometry.max_rows), K, segments, [o[rows] for o in outs])
    launches = -(-M // geometry.max_rows)
    w8a16_launches += launches
    w8a16_fused_launches += launches if len(segments) > 1 else 0
    return outs


# ---------------------------------------------------------- K7 (CUDA C++)
@functools.lru_cache(maxsize=None)
def _kv_write_entry():
    """K7's C entry point, built and bound once per process."""
    from internnav_tpu_torch.ops._build import load_library

    fn = load_library("rope_kv_write.cu").rope_kv_write
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kv_write_launch(k, v, k_entry: KVEntry, v_entry: KVEntry, cache_len, B: int, n: int,
                     rotary=None) -> Optional[torch.Tensor]:
    """Launch K7: k/v bf16 with B n KV D elements, entries int8 (B, Tmax,
    KV, D) + fp32 (B, Tmax, KV, 1), cache_len (B,) int32/int64, and
    `rotary` (q (B n, H D) bf16, cos, sin fp32 (B, n, D)) or None. Returns
    the rotated q (B, H, n, D), or None without rotary."""
    global kv_write_launches
    kernel = "KV write kernel"
    dev = k.device
    Tmax, KV, D = k_entry[0].shape[1:]
    if D not in KV_WRITE_HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {D} is not one of {KV_WRITE_HEAD_DIMS}")
    if n > Tmax:
        raise ValueError(f"{kernel}: a write of {n} tokens does not fit a cache of {Tmax}")
    for name, t in (("k", k), ("v", v)):
        _check_cuda(name, t, torch.bfloat16, (B * n, KV * D), dev, kernel)
    for name, (data, scale) in (("k", k_entry), ("v", v_entry)):
        _check_cuda(f"the {name} cache", data, torch.int8, (B, Tmax, KV, D), dev, kernel)
        _check_cuda(f"the {name} cache scale", scale, torch.float32, (B, Tmax, KV, 1), dev,
                    kernel)
    if cache_len.device != dev or tuple(cache_len.shape) != (B,) \
            or cache_len.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{kernel}: cache_len must be int32/int64 ({B},) on {dev}")
    cache_len = cache_len.contiguous()
    q_rot = q = cos = sin = None
    H = 0
    if rotary is not None:
        q, cos, sin = rotary
        H = q.shape[-1] // D
        _check_cuda("q", q, torch.bfloat16, (B * n, H * D), dev, kernel)
        _check_cuda("cos", cos, torch.float32, (B, n, D), dev, kernel)
        _check_cuda("sin", sin, torch.float32, (B, n, D), dev, kernel)
        q_rot = torch.empty((B, H, n, D), dtype=torch.bfloat16, device=dev)
    if B * n:
        ptr = [None if t is None else t.data_ptr()
               for t in (q, k, v, cos, sin, q_rot, *k_entry, *v_entry, cache_len)]
        with torch.cuda.device(dev.index):
            err = _kv_write_entry()(*ptr, int(cache_len.dtype == torch.int64), B, n, H, KV, D,
                                    Tmax, _stream(dev))
        if err != 0:
            raise RuntimeError(f"KV write kernel launch failed: cudaError_t {err}")
        kv_write_launches += 1
    return q_rot


def rope_kv_write_cuda(q, k, v, cos, sin, k_entry: KVEntry, v_entry: KVEntry, cache_len
                       ) -> torch.Tensor:
    """Launch K7 with rotary: q (B n, H D), k/v (B n, KV D) contiguous bf16,
    cos/sin (B, n, D) fp32; entries contiguous int8 (B, Tmax, KV, D) and
    fp32 (B, Tmax, KV, 1); cache_len (B,) int32/int64. Writes K and V at the
    slots of `cache_write_slots` (the rule applied on the device, with no
    host synchronisation) and returns the rotated q (B, H, n, D)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("cos", cos)):
        if not t.is_cuda:
            raise ValueError(f"KV write kernel: {name} must be a CUDA tensor, got one on "
                             f"{t.device}")
    B, n = cos.shape[:2]
    return _kv_write_launch(k, v, k_entry, v_entry, cache_len, B, n, rotary=(q, cos, sin))


def write_kv_cache_cuda(k, v, k_entry: KVEntry, v_entry: KVEntry, cache_len) -> None:
    """Launch K7 without rotary: k/v contiguous bf16 (B, n, KV, D); the rest
    as `rope_kv_write_cuda`."""
    if not k.is_cuda or k.dim() != 4:
        raise ValueError(f"KV write kernel: k must be a bf16 (B, n, KV, D) CUDA tensor, got "
                         f"{tuple(k.shape)} on {k.device}")
    B, n = k.shape[:2]
    for name, t in (("k", k), ("v", v)):
        _check_cuda(name, t, torch.bfloat16, k.shape, k.device, "KV write kernel")
    _kv_write_launch(k.view(B * n, -1), v.view(B * n, -1), k_entry, v_entry, cache_len, B, n)
