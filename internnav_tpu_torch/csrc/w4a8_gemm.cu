// K9: the W4A8 GEMM of `weight_dtype="int4"`, CUDA C++ for sm_90a.
//
// Replaces the XLA int4 product of internnav_tpu/model/basemodel/
// internvla_n1/qwen_text.py `QuantDense.__call__` at weight_bits=4
// (:140-143, the s4 -> s8 widening at the dot's operand load, and
// :177-196, the int8 x int8 dot with int32 sums and its fp32 epilogue):
//   per-channel  y = (float(acc) * a_scale[m]) * scale[n] (+ bias[n])
//   grouped      y = (sum_g float(acc_g) * scale[g, n]) * a_scale[m] (+ bias[n])
// then bf16. xq (M, K) int8 and a_scale (M, 1) come from K6a; weight (N, K
// / 2) uint8 holds two signed codes a byte along K, the even k in the low
// nibble (`quant.pack_int4`).
//
// What bounds it: at decode rows (a token, the 4-query latent chunk, 12 to
// 48 grouped rows) the weight bytes: a byte holds two weights, so a
// product does at most 2 M int8 operations per weight byte against the
// ~590 per byte (1,979 TOP/s over 3.35 TB/s) at which the tensor cores
// would set the pace. At the prompt (M = 1,088 and 4,864) the int8
// operations, and with grouped scales the fold of every group term (an
// exact fp64 product and sum for each output a group).
//
// Design: K6b's two kernels (quant_gemm.cuh), templated on the code width.
// - Decode rows (M <= 64): K6b's TMA ring, its plan, its split clusters and
//   persistent blocks, and its multi-segment launch: q/k/v and gate/up take
//   one launch each (`quant.w4a8_linear_multi`). A 128-byte line carries
//   256 k of packed codes, so a stage carries twice the k of K6b's; each
//   consumer lane widens its 8 bytes to 16 int8 codes (each times 16: two
//   masks and byte permutes, no sign fix) after the shared-memory load,
//   before mma.sync m16n8k32 s8; the int32 sums are shifted back by 4. The
//   consumers' products, not the bytes in flight, set the pace: 8 warps of
//   8 columns a block, rings of at most 3 stages (`DecodeGeometry`), the
//   group scale rows staged by the producer and each line's two groups
//   folded after its products; at 17 to 64 rows two blocks an SM (their
//   launch bounds ask for it) with rings of 2 stages.
// - Prompt rows (M > 64): K6b's wgmma s8 tiles from a TMA ring whose stages
//   carry the codes packed; the consumer warpgroups widen each stage into
//   a 128-byte-swizzled int8 tile, which wgmma reads as K6b's; grouped
//   scales take 128 x 64 tiles whose group folds overlap the next stage's
//   products.
// - The sums: grouped terms acc_g * scale[g, n], each exact in fp64, are
//   added there and rounded once, in both kernels and every split: the sum
//   is exact in practice, so order-free, and a row's bits do not depend on
//   M, the split, the tile or the launch's other projections (a decode
//   step equals a re-prefill of the same tokens). The JAX fold
//   (qwen_text.py:189) rounds each term to fp32 first; the plain version
//   does, and the kernel agrees with it within GROUPED_TOL. K6b's grouped
//   fold, fp32 and split-order dependent, is not used. Per-channel int32
//   sums are exact in any order.

#include "quant_gemm.cuh"

// Prefill tiles (M > 64). xq (M, K) int8, a_scale (M,) fp32, weight (N, K
// / 2) packed int4, scale (N,) fp32 or, with group > 0, (K / group, N)
// fp32; bias (N,) fp32 or null; out (M, N) bf16. K % 64 == 0 and group %
// 64 == 0, every pointer 16-byte aligned (checked by the wrapper). Returns
// a cudaError_t (0 = launched).
extern "C" int w4a8_gemm_prefill(const void* xq, const void* a_scale, const void* weight,
                                 const void* scale, const void* bias, void* out, int M, int N,
                                 int K, int group, void* stream) {
  return static_cast<int>(qgemm::prefill<4>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(a_scale), weight,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K, group, static_cast<cudaStream_t>(stream)));
}

// Decode ring (1 <= M <= 64): up to 3 segments (projections of the same
// xq (M, K) and a_scale (M,)), segment i with packed int4 codes wi (Ni, K /
// 2), scale si (Ni,) or (K / group, Ni) fp32, bias bi (Ni,) fp32 or null,
// out oi (M, Ni) bf16. The plan is `quant.gemm_decode_plan` at K9's line
// (256 k); the arguments as K6b's `w8a8_gemm_decode`. Returns a
// cudaError_t.
extern "C" int w4a8_gemm_decode(const void* xq, const void* a_scale, int M, int K, int group,
                                int nseg, int block_n, int split, int unit_lines, int stages,
                                int blocks, const void* w0, const void* s0, const void* b0,
                                void* o0, int N0, const void* w1, const void* s1,
                                const void* b1, void* o1, int N1, const void* w2,
                                const void* s2, const void* b2, void* o2, int N2,
                                void* stream) {
  return qgemm::decode_entry<qgemm::W4A8>(xq, a_scale, M, K, group, nseg, block_n, split,
                                          unit_lines, stages, blocks, {w0, w1, w2},
                                          {s0, s1, s2}, {b0, b1, b2}, {o0, o1, o2}, {N0, N1, N2},
                                          stream);
}
