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
// What bounds it: the weight bytes. It runs only at decode (M <= 192: a
// token, the 4-query latent chunk, 12 to 192 grouped rows, and the
// lm_head's 152,064 x 3,584 int8 weights at a decode step), where a
// product does at most 2 M bf16 operations per int8 weight byte (4 M per
// int4 byte) against the ~295 per byte (989 TFLOP/s over 3.35 TB/s) at
// which the tensor cores would set the pace.
//
// Design (wgemm_tiles.cuh): a simple right kernel first. Each lane widens
// its 16 codes of a weight row to 8 bf16 pairs in registers (int4 first
// to int8 by mask, per-byte sign fix and byte permutes), exact since
// |code| <= 127, and mma.sync m16n8k16 bf16 takes them with the
// activation rows, both straight from global memory; no dequantized copy
// of the weight exists. The decode tiles split K over 8 warps of a block
// (whole scale groups each; partials added in shared memory in a fixed
// order, so a launch's bits never change), and each warp keeps its next
// chunk's loads in flight. Above 16 rows the 64 x 64 prefill tiles run.
// Within a 64-wide chunk the fp32 sums run in the tensor cores' order;
// the chunks' (per channel) or the groups' scaled sums (grouped) are added
// in fp64 (exact in practice, so in any order: the decode and prefill
// tiles agree bit for bit) and rounded once. So the kernel agrees with
// its plain version to fp32 rounding, not bit for bit.

#include "wgemm_tiles.cuh"

namespace {

template <int BITS>
struct W8A16Op {
  using Acc = float;
  static constexpr bool kFoldChunks = true;  // per channel: chunk sums added in fp64
  // the bytes of 16 k of a weight row: 16 int8 or 8 packed int4
  using WeightBytes = typename std::conditional<BITS == 4, uint2, uint4>::type;
  template <int NT>
  struct Chunk {
    uint4 a0[2], a1[2];  // 16 k of activation rows g and g + 8 (bf16)
    WeightBytes b[NT];   // 16 k of weight row g of each n8 tile
  };

  template <int NT>
  __device__ __forceinline__ static void load(Chunk<NT>& c, const wgemm::Params& p, int r0,
                                              int r1, int n0, int kc, int g, int t) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
    const int k = kc + 16 * t;
    const __nv_bfloat16* x0 = x + static_cast<size_t>(r0) * p.K + k;
    const __nv_bfloat16* x1 = x + static_cast<size_t>(r1) * p.K + k;
    c.a0[0] = wgemm::load_or_zero<uint4>(x0, r0 < p.M);
    c.a0[1] = wgemm::load_or_zero<uint4>(x0 + 8, r0 < p.M);
    c.a1[0] = wgemm::load_or_zero<uint4>(x1, r1 < p.M);
    c.a1[1] = wgemm::load_or_zero<uint4>(x1 + 8, r1 < p.M);
    const size_t row_bytes = BITS == 4 ? p.K / 2 : p.K;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + nt * 8 + g;
      c.b[nt] = wgemm::load_or_zero<WeightBytes>(
          p.w + static_cast<size_t>(n) * row_bytes + (BITS == 4 ? k / 2 : k), n < p.N);
    }
  }

  template <int NT>
  __device__ __forceinline__ static void mma(float (&acc)[NT][4], const Chunk<NT>& c) {
    const uint32_t a0[8] = {c.a0[0].x, c.a0[0].y, c.a0[0].z, c.a0[0].w,
                            c.a0[1].x, c.a0[1].y, c.a0[1].z, c.a0[1].w};
    const uint32_t a1[8] = {c.a1[0].x, c.a1[0].y, c.a1[0].z, c.a1[0].w,
                            c.a1[1].x, c.a1[1].y, c.a1[1].z, c.a1[1].w};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t w[4];  // int8 codes of k 4j .. 4j + 3 in word j
      if constexpr (BITS == 4) {
        wgemm::unpack_int4x16(c.b[nt], w);
      } else {
        w[0] = c.b[nt].x;
        w[1] = c.b[nt].y;
        w[2] = c.b[nt].z;
        w[3] = c.b[nt].w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgemm::mma_bf16(acc[nt], a0[2 * j], a1[2 * j], a0[2 * j + 1], a1[2 * j + 1],
                        wgemm::s8x2_to_bf16x2(w[j], 0), wgemm::s8x2_to_bf16x2(w[j], 1));
      }
    }
  }

  // no per-row factor: the activations were not quantized
  __device__ __forceinline__ static float finish(float v, const wgemm::Params&, int) {
    return v;
  }
};

}  // namespace

// x (M, K) bf16, weight (N, K) int8 (bits 8) or (N, K / 2) packed int4
// (bits 4), scale (N,) or (K / group, N) fp32, bias (N,) fp32 or null, out
// (M, N) bf16; K a multiple of 64, group 0 or a multiple of 64 dividing K,
// every pointer 16-byte aligned (checked by the wrapper). Returns the
// launch's cudaError_t.
extern "C" int w8a16_gemm(const void* x, const void* weight, const void* scale,
                          const void* bias, void* out, int M, int N, int K, int group, int bits,
                          void* stream) {
  const wgemm::Params p{x,
                        nullptr,
                        static_cast<const uint8_t*>(weight),
                        static_cast<const float*>(scale),
                        static_cast<const float*>(bias),
                        static_cast<__nv_bfloat16*>(out),
                        M,
                        N,
                        K,
                        group};
  if (bits == 4) return wgemm::launch<W8A16Op<4>>(p, stream);
  if (bits == 8) return wgemm::launch<W8A16Op<8>>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
