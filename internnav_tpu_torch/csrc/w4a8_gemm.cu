// K9: the W4A8 GEMM of `weight_dtype="int4"`, CUDA C++ for sm_90a.
//
// Replaces the XLA int4 product of internnav_tpu/model/basemodel/
// internvla_n1/qwen_text.py `QuantDense.__call__` at weight_bits=4
// (:140-143, the s4 -> s8 widening at the dot's operand load, and
// :177-196, the int8 x int8 dot with int32 sums and its fp32 epilogue):
//   per-channel  y = (float(acc) * a_scale[m]) * scale[n] (+ bias[n])
//   grouped      y = (sum_g float(acc_g) * scale[g, n]) * a_scale[m] (+ bias[n])
// then bf16: K6b's epilogue, its group terms float(acc_g) * scale[g, n]
// rounded in fp32 as there and summed in fp64 (exact in practice, so in
// any order: the decode and prefill tiles agree bit for bit; the sum
// then rounded once). xq (M, K) int8 and a_scale (M, 1) come from K6a; weight (N, K /
// 2) uint8 holds two signed codes a byte along K, the even k in the low
// nibble (`quant.pack_int4`).
//
// What bounds it: at decode rows (M <= 16, the 4-query latent chunk and
// 12 grouped rows included) the weight bytes: a byte holds two weights,
// so a product does at most 64 int8 operations per weight byte against the
// ~590 per byte (1,979 TOP/s over 3.35 TB/s) at which the tensor cores
// would set the pace. At the prompt (M = 1,088 and 4,864) the int8
// operations.
//
// Design (wgemm_tiles.cuh): a simple right kernel first. The codes are
// widened to int8 in registers as they are loaded (mask, per-byte sign
// fix, byte permutes: no dequantized copy anywhere), and mma.sync
// m16n8k32 s8 multiplies them with the activation rows, both straight
// from global memory. The decode tiles give 16 columns to a block of 8
// warps that split K (whole scale groups each) and add their partials in
// shared memory in a fixed order, so even the 512-wide k/v projections
// spread over 32 blocks of 8 warps each streaming its share; each warp
// keeps its next chunk's loads in flight. The prefill tiles are 64 x 64
// with 4 warps of 16 rows; the activation panel is reread from L1/L2 by
// every column block. TMA rings and wgmma, as K6b has, are later work.

#include "wgemm_tiles.cuh"

namespace {

struct W4A8Op {
  using Acc = int;
  static constexpr bool kFoldChunks = false;  // per channel: one exact int32 sum
  template <int NT>
  struct Chunk {
    uint4 a0, a1;  // 16 k of activation rows g and g + 8
    uint2 b[NT];   // 16 packed k of weight row g of each n8 tile
  };

  template <int NT>
  __device__ __forceinline__ static void load(Chunk<NT>& c, const wgemm::Params& p, int r0,
                                              int r1, int n0, int kc, int g, int t) {
    const int8_t* x = static_cast<const int8_t*>(p.x);
    const int k = kc + 16 * t;
    c.a0 = wgemm::load_or_zero<uint4>(x + static_cast<size_t>(r0) * p.K + k, r0 < p.M);
    c.a1 = wgemm::load_or_zero<uint4>(x + static_cast<size_t>(r1) * p.K + k, r1 < p.M);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + nt * 8 + g;
      c.b[nt] = wgemm::load_or_zero<uint2>(p.w + static_cast<size_t>(n) * (p.K / 2) + k / 2,
                                           n < p.N);
    }
  }

  template <int NT>
  __device__ __forceinline__ static void mma(int (&acc)[NT][4], const Chunk<NT>& c) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[4];
      wgemm::unpack_int4x16(c.b[nt], b);
      wgemm::mma_s8(acc[nt], c.a0.x, c.a1.x, c.a0.y, c.a1.y, b[0], b[1]);
      wgemm::mma_s8(acc[nt], c.a0.z, c.a1.z, c.a0.w, c.a1.w, b[2], b[3]);
    }
  }

  // the activation row's scale
  __device__ __forceinline__ static float finish(float v, const wgemm::Params& p, int r) {
    return __fmul_rn(v, p.a_scale[r]);
  }
};

}  // namespace

// xq (M, K) int8, a_scale (M,) fp32, weight (N, K / 2) packed int4, scale
// (N,) or (K / group, N) fp32, bias (N,) fp32 or null, out (M, N) bf16;
// K a multiple of 64, group 0 or a multiple of 64 dividing K, every
// pointer 16-byte aligned (checked by the wrapper). Returns the launch's
// cudaError_t.
extern "C" int w4a8_gemm(const void* xq, const void* a_scale, const void* weight,
                         const void* scale, const void* bias, void* out, int M, int N, int K,
                         int group, void* stream) {
  const wgemm::Params p{xq,
                        static_cast<const float*>(a_scale),
                        static_cast<const uint8_t*>(weight),
                        static_cast<const float*>(scale),
                        static_cast<const float*>(bias),
                        static_cast<__nv_bfloat16*>(out),
                        M,
                        N,
                        K,
                        group};
  return wgemm::launch<W4A8Op>(p, stream);
}
