// K6b: the W8A8 GEMM of the int8 `realtime` serving profile, CUDA C++ for
// sm_90a.
//
// Replaces the XLA int8 product of internnav_tpu/model/basemodel/
// internvla_n1/qwen_text.py `QuantDense.__call__` (:177-199): y =
// dequant(xq @ kernel_q) with xq the per-token int8 activations (K6a),
// exact int32 accumulation, and the fp32 epilogue in the JAX order:
//   per-channel  y = (float(acc) * a_scale[m]) * scale[n] (+ bias[n])
//   grouped      y = (sum_g float(acc_g) * scale[g, n]) * a_scale[m] (+ bias[n])
// then bf16. The per-channel epilogue uses __fmul_rn / __fadd_rn (no FMA
// contraction), so it equals the plain version bit for bit.
//
// Layout: xq (M, K) int8 row-major, weight_q (N, K) int8 with K contiguous
// (both K-major: the only layout 8-bit tensor-core products take), out
// (M, N) bf16.
//
// Two kernels, by M (both in quant_gemm.cuh, shared with K9 and K10):
// - Decode (M <= 16): bound by the weight bytes. At 16 rows a product does
//   at most 32 int8 operations per weight byte; the card needs ~590 per
//   byte (1,979 TOP/s over 3.35 TB/s) before the tensor cores set the
//   pace. So the design reads every weight byte once and keeps every SM
//   streaming the same share of them for the whole launch:
//   - One launch serves up to 3 projections of one input (q/k/v, gate/up;
//     a table of {weight map, scale, bias, out, N} segments). The work
//     units are (64-column tile of a segment, K slice); the plan (split,
//     ring depth, grid) comes from the wrapper (`quant.gemm_decode_plan`),
//     which picks the split that gives the SMs equal bytes.
//   - Split launches (too few column tiles for the card: q/k/v, o, down):
//     the S K-slices of a column tile form one thread-block cluster. Each
//     block sums its slice in int32 (or folds whole scale groups in fp32)
//     and stores its partial rows into rank 0's shared memory (st.async,
//     counted on rank 0's mbarrier); rank 0 adds the S partials in rank
//     order and writes the tile. No atomics, no scratch; int32 sums are
//     exact, so any split gives the same bits.
//   - Whole-K launches (gate/up, the lm_head): persistent blocks, each
//     walking every grid-th column tile with its ring running on from one
//     tile to the next; each consumer warp writes its columns from its
//     registers.
//   - One producer warp streams the tile's 128-byte k-lines of weight_q
//     (64 rows, 128-byte swizzle, by TMA from a tensor map cached per
//     weight), the M activation rows of the same line (bulk copies, no
//     tensor map per call) and with grouped scales the scale row of each
//     group ending in the line (cp.async) into a ring of up to 6 stages
//     (full / empty mbarriers); rows and columns past the matrix arrive as
//     zeros. Four consumer warps, 16 columns each, run mma.sync.m16n8k32
//     from shared memory while the next stages land: each lane loads 16 contiguous
//     bytes of a weight row and of each activation row, the k order
//     inside a 64-byte chunk permuted the same way for both operands
//     (which leaves the dot product unchanged).
// - Prefill (M > 16): bound by int8 operations. A block computes a 128 x BN
//   output tile (BN = 128 or 256) with wgmma m64nBNk32 .s32.s8.s8, both
//   operands from shared memory. One producer warp streams the k lines of
//   xq (128 rows) and weight_q (BN rows), 128 bytes each, by TMA with
//   128-byte swizzle into a ring of STAGES stages (full / empty mbarriers);
//   two consumer warpgroups each own 64 rows of the tile and issue the 4
//   k-steps of a stage while the next stages land, releasing a stage once
//   the products that read it are done. Blocks run along M first, so the
//   blocks that share a weight panel run together and read it from device
//   memory once; the activation panel stays in L2. Rows past M and columns
//   past N arrive as zeros and are not stored. Grouped scales fold the
//   int32 sum into fp32 at the end of each group (restarting the sum).
// Both store bf16 pairs where the pair's address is 4-byte aligned ((m N +
// n) even), else one value at a time: odd N works.

#include "quant_gemm.cuh"

// Prefill tiles (M > 16). xq (M, K) int8, a_scale (M,) fp32, weight_q (N,
// K) int8, scale (N,) fp32 or, with group > 0, (K / group, N) fp32; bias
// (N,) fp32 or null; out (M, N) bf16. K % 64 == 0 and group % 64 == 0, xq
// and weight_q 16-byte aligned (checked by the wrapper). Returns a
// cudaError_t (0 = launched).
extern "C" int w8a8_gemm_prefill(const void* xq, const void* a_scale, const void* weight_q,
                                 const void* scale, const void* bias, void* out, int M, int N,
                                 int K, int group, void* stream) {
  return static_cast<int>(qgemm::prefill<8>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(a_scale), weight_q,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K, group, static_cast<cudaStream_t>(stream)));
}

// Decode tiles (1 <= M <= 16): up to 3 segments (projections of the same
// xq (M, K) and a_scale (M,)), segment i with weight wi (Ni, K) int8,
// scale si (Ni,) or (K / group, Ni) fp32, bias bi (Ni,) fp32 or null, out
// oi (M, Ni) bf16; segments past nseg are ignored. The plan
// (`quant.gemm_decode_plan`): block_n (must be 64), split (the K slices of
// a column tile and the cluster size, 1-8), unit_lines (the 128-byte lines
// of a split unit), stages (ring depth, 1-6), blocks (the grid: column
// tiles x split, or with split 1 at most the tiles, each block walking
// every blocks-th tile). Returns a cudaError_t.
extern "C" int w8a8_gemm_decode(const void* xq, const void* a_scale, int M, int K, int group,
                                int nseg, int block_n, int split, int unit_lines, int stages,
                                int blocks, const void* w0, const void* s0, const void* b0,
                                void* o0, int N0, const void* w1, const void* s1,
                                const void* b1, void* o1, int N1, const void* w2,
                                const void* s2, const void* b2, void* o2, int N2,
                                void* stream) {
  return qgemm::decode_entry<qgemm::W8A8>(xq, a_scale, M, K, group, nseg, block_n, split,
                                          unit_lines, stages, blocks, {w0, w1, w2},
                                          {s0, s1, s2}, {b0, b1, b2}, {o0, o1, o2}, {N0, N1, N2},
                                          stream);
}
