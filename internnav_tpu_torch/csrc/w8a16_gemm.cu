// K10: the W8A16 / W4A16 GEMM of `decode_act_dtype="bf16"`, CUDA C++ for
// sm_90a.
//
// Replaces the XLA `bf16_act` product of internnav_tpu/model/basemodel/
// internvla_n1/qwen_text.py `QuantDense.__call__` (:153-171), which the
// cached-decode projections run under decode_act_dtype="bf16": the
// activations stay bf16 (no per-token quantization), the int8 or int4
// codes are widened to bf16 at the dot's operand load, the products are
// summed in fp32, and
//   per-channel  y = acc * scale[n] (+ bias[n])
//   grouped      y = sum_g acc_g * scale[g, n] (+ bias[n])
// then bf16. x (M, K) bf16; weight (N, K) int8, or (N, K / 2) uint8 with
// two signed codes a byte, the even k in the low nibble.
//
// What bounds it: the weight bytes at decode rows. It runs at cached passes
// (a token, the 4-query latent chunk, 12 to 192 grouped rows, and the
// lm_head's 152,064 x 3,584 int8 weights at a decode step; a pass of more
// than 192 rows takes one launch per 192 rows, `quant.w8a16_decode_cuda`), where
// a product does at most 2 M bf16 operations per int8 weight byte (4 M per
// int4 byte) against the ~295 per byte (989 TFLOP/s over 3.35 TB/s) at
// which the tensor cores would set the pace; above ~48 rows the consumers'
// products and the M activation rows each tile re-reads set it.
//
// Design: K6b's decode ring (quant_gemm.cuh) with bf16 rows. A producer
// warp streams 128-byte k-lines of the codes by TMA (128 int8 or 256 int4
// k a line), the rows' bf16 values of the same k by bulk copies and the
// group scale rows by cp.async into a ring of at most 3 stages; the
// consumers widen the codes to bf16 in registers (int4 first to int8, each
// times 16, by two masks and byte permutes; int8 to bf16 by a byte permute
// under an fp32 exponent and one subtraction, no conversion instruction;
// all exact since |code| <= 127) and run mma.sync m16n8k16 bf16 from
// shared memory. One launch serves the projections of one input (q/k/v,
// gate/up: `quant.w8a16_linear_multi`), split over the SMs by
// `quant.gemm_decode_plan` at K10's line geometry: a K split over a
// thread-block cluster (to 64 rows) or persistent whole-K blocks. Up to 16
// rows 8 warps of 8 columns take a tile; above, two rows of 4 warps of 16
// columns, each warp up to 6 m-tiles, so every code is read once a launch
// at every M <= 192. At 17 to 64 rows (two m-tiles a warp) the launch
// bounds ask for two blocks an SM (at most 113 registers a thread):
// one block's consumers alone left the SM waiting on their products
// (PERF.md §6). No dequantized copy of the weight exists.
//
// The sums. One instruction family (mma.sync m16n8k16) serves every M, so
// a 16-k step rounds alike for every row. A scale group's fp32 sum (per
// channel: a line's) is multiplied by its scale exactly in fp64 and added
// there, and rounded to fp32 once; int4 sums, of codes taken 16 times, are
// scaled back by 1/16 exactly first. The fp64 sum is exact in practice, so
// order-free: a row's bits do not depend on M, the split, the tile or the
// launch's other projections, and the kernel agrees with its plain version
// (whose fp32 sums run in the CPU's order) to fp32 rounding, not bit for
// bit.

#include "quant_gemm.cuh"

// x (M, K) bf16 (1 <= M <= 192), up to 3 segments (projections of x),
// segment i with codes wi (Ni, K) int8 (bits 8) or (Ni, K / 2) packed int4
// (bits 4), scale si (Ni,) or (K / group, Ni) fp32, bias bi (Ni,) fp32 or
// null, out oi (M, Ni) bf16. The plan is `quant.gemm_decode_plan` at K10's
// geometry; the arguments as K6b's `w8a8_gemm_decode` (split 1 above 64
// rows). K a multiple of 64, group 0 or a multiple of 64 dividing K, every
// pointer 16-byte aligned (checked by the wrapper). Returns a cudaError_t.
extern "C" int w8a16_gemm_decode(const void* x, int M, int K, int group, int bits, int nseg,
                                 int block_n, int split, int unit_lines, int stages, int blocks,
                                 const void* w0, const void* s0, const void* b0, void* o0,
                                 int N0, const void* w1, const void* s1, const void* b1,
                                 void* o1, int N1, const void* w2, const void* s2,
                                 const void* b2, void* o2, int N2, void* stream) {
  if (bits == 4) {
    return qgemm::decode_entry<qgemm::W16<4>>(x, nullptr, M, K, group, nseg, block_n, split,
                                              unit_lines, stages, blocks, {w0, w1, w2},
                                              {s0, s1, s2}, {b0, b1, b2}, {o0, o1, o2},
                                              {N0, N1, N2}, stream);
  }
  if (bits == 8) {
    return qgemm::decode_entry<qgemm::W16<8>>(x, nullptr, M, K, group, nseg, block_n, split,
                                              unit_lines, stages, blocks, {w0, w1, w2},
                                              {s0, s1, s2}, {b0, b1, b2}, {o0, o1, o2},
                                              {N0, N1, N2}, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
