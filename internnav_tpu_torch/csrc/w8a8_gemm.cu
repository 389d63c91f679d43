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
// (the K-major B operand that mma.sync s8 takes), out (M, N) bf16.
//
// Bound: at decode (M = 1 or 4) by the weight bytes, at prefill (M = T) by
// int8 operations. Design (a simple kernel first; wgmma and TMA are later
// work): one block of 4 warps computes a (16*MT) x (8*NT) output tile; the
// 4 warps split K (in whole scale groups) and their exact int32 partials are
// summed in shared memory. Each lane loads 16 contiguous bytes of a weight
// row and of each activation row straight into mma.sync.m16n8k32 fragments:
// the k order inside a 64-wide chunk is permuted the same way for A and B,
// which leaves the dot product unchanged. Decode tiles (MT=1, NT=2) keep U=4
// chunks of loads in flight per warp; prefill tiles (MT=4, NT=4) reuse each
// fragment across 16 products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kChunk = 64;

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int MT, int NT, int U, bool GROUPED>
__global__ void __launch_bounds__(kWarps * 32)
    w8a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ a_scale,
                     const int8_t* __restrict__ wq, const float* __restrict__ scale,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M,
                     int N, int K, int group) {
  constexpr int BM = 16 * MT, BN = 8 * NT;
  __shared__ uint32_t red[kWarps * BM * BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  // this warp's K range, in whole units (a scale group, or one chunk)
  const int unit = GROUPED ? group / kChunk : 1;
  const int units = K / kChunk / unit;
  const int c_begin = (warp * units / kWarps) * unit;
  const int c_end = ((warp + 1) * units / kWarps) * unit;

  // rows past M or N are clamped (loaded, never stored)
  const int4* arow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(m0 + mt * 16 + g + 8 * h, M - 1);
      arow[mt][h] = reinterpret_cast<const int4*>(xq + (size_t)r * K + t * 16);
    }
  const int4* brow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = min(n0 + nt * 8 + g, N - 1);
    brow[nt] = reinterpret_cast<const int4*>(wq + (size_t)n * K + t * 16);
  }

  int acc[MT][NT][4];
  float facc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0;
        facc[mt][nt][i] = 0.f;
      }

  for (int c = c_begin; c < c_end; c += U) {
    int4 a[U][MT][2], b[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c + u < c_end) {
        const int off = (c + u) * (kChunk / 16);  // in int4 units
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[u][mt][0] = arow[mt][0][off];
          a[u][mt][1] = arow[mt][1][off];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) b[u][nt] = __ldg(brow[nt] + off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c + u < c_end) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int4 lo = a[u][mt][0], hi = a[u][mt][1], w = b[u][nt];
            mma_s8(acc[mt][nt], lo.x, hi.x, lo.y, hi.y, w.x, w.y);
            mma_s8(acc[mt][nt], lo.z, hi.z, lo.w, hi.w, w.z, w.w);
          }
        if (GROUPED && (c + u + 1) % unit == 0) {  // a group ends: fold it in fp32
          const float* s = scale + (size_t)((c + u) / unit) * N;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = min(n0 + nt * 8 + 2 * t, N - 2);
            const float s0 = s[n], s1 = s[n + 1];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                facc[mt][nt][i] += (float)acc[mt][nt][i] * ((i & 1) ? s1 : s0);
                acc[mt][nt][i] = 0;
              }
          }
        }
      }
    }
  }

  // each warp's partial tile into shared memory: c0, c1 at row g, c2, c3 at
  // row g + 8; columns 2t, 2t + 1
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = mt * 16 + g + 8 * (i >> 1), col = nt * 8 + 2 * t + (i & 1);
        red[(warp * BM + row) * BN + col] =
            GROUPED ? __float_as_uint(facc[mt][nt][i]) : (uint32_t)acc[mt][nt][i];
      }
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += kWarps * 32) {
    const int row = idx / BN, col = idx % BN;
    const int m = m0 + row, n = n0 + col;
    if (m >= M || n >= N) continue;
    float y;
    if (GROUPED) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += __uint_as_float(red[(w * BM + row) * BN + col]);
      y = __fmul_rn(sum, a_scale[m]);
    } else {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += (int)red[(w * BM + row) * BN + col];
      y = __fmul_rn(__fmul_rn((float)sum, a_scale[m]), scale[n]);
    }
    if (bias != nullptr) y = __fadd_rn(y, bias[n]);
    out[(size_t)m * N + n] = __float2bfloat16_rn(y);
  }
}

template <int MT, int NT, int U>
void launch(const int8_t* xq, const float* a_scale, const int8_t* wq, const float* scale,
            const float* bias, __nv_bfloat16* out, int M, int N, int K, int group,
            cudaStream_t stream) {
  const dim3 grid((N + 8 * NT - 1) / (8 * NT), (M + 16 * MT - 1) / (16 * MT));
  if (group)
    w8a8_gemm_kernel<MT, NT, U, true>
        <<<grid, kWarps * 32, 0, stream>>>(xq, a_scale, wq, scale, bias, out, M, N, K, group);
  else
    w8a8_gemm_kernel<MT, NT, U, false>
        <<<grid, kWarps * 32, 0, stream>>>(xq, a_scale, wq, scale, bias, out, M, N, K, 0);
}

}  // namespace

// xq (M, K) int8, a_scale (M,) fp32, weight_q (N, K) int8, scale (N,) fp32
// or, with group > 0, (K / group, N) fp32; bias (N,) fp32 or null; out
// (M, N) bf16. K % 64 == 0 and group % 64 == 0 (checked by the wrapper).
// Returns cudaGetLastError() after the launch.
extern "C" int w8a8_gemm(const void* xq, const void* a_scale, const void* weight_q,
                         const void* scale, const void* bias, void* out, int M, int N, int K,
                         int group, void* stream) {
  const auto x = static_cast<const int8_t*>(xq);
  const auto a = static_cast<const float*>(a_scale);
  const auto w = static_cast<const int8_t*>(weight_q);
  const auto sc = static_cast<const float*>(scale);
  const auto b = static_cast<const float*>(bias);
  const auto o = static_cast<__nv_bfloat16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (M <= 16)  // decode: 16 columns a block, 4 chunks of loads in flight
    launch<1, 2, 4>(x, a, w, sc, b, o, M, N, K, group, s);
  else  // prefill: 64 x 32 tiles
    launch<4, 4, 1>(x, a, w, sc, b, o, M, N, K, group, s);
  return (int)cudaGetLastError();
}
