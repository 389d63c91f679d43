// The tile walk shared by K9 (w4a8_gemm.cu) and K10 (w8a16_gemm.cu): two
// GEMMs of quantized weights (N, K), K contiguous, against M activation
// rows, written with mma.sync from registers.
//
// A block computes (16 WM) rows x (8 NT) columns with WM x WK warps. Warp
// (wm, wk) owns rows 16 wm.. of the tile and walks every WK-th K unit:
// one scale group when the scales are grouped, else one 64-wide k chunk.
// Where WK > 1 the warps' partials meet in shared memory and warp 0 adds
// them in wk order: no atomics, so a launch gives the same bits every
// time (a CUDA graph replay equals the eager call).
//
// The decode tiles (K split over 8 warps) and the prefill tiles (one warp
// over all of K) must give a row the same bits, or a decode step and a
// re-prefill of the same tokens drift apart through the int8 codes of
// the layers after (measured at 28 layers). So a sum that spans units is
// order-free: each group's fp32 product float(acc_g) * scale[g] (the JAX
// fold's term, rounded as there) and K10's fp32 per-chunk sums are added
// in fp64, where a sum of fp32 terms is exact unless they span more than
// 2^(29 - log2(units)) in magnitude, and rounded to fp32 once. Integer
// sums (K9 per channel) are exact in any order.
//
// Operands come straight from global memory into registers: a lane
// (g = lane / 4, t = lane % 4) loads 16 contiguous k of activation rows g
// and g + 8 and of weight row g of each n8 tile. Inside a chunk, the
// hardware's k order of a fragment is mapped onto those 16 k the same way
// for both operands, which leaves every dot product unchanged. The next
// chunk's loads are issued before the current chunk's products, so each
// warp keeps two chunks of weights in flight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace wgemm {

constexpr int CHUNK = 64;  // k a step

// mma.sync m16n8k32 s8 x s8 -> s32, accumulating into c
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// mma.sync m16n8k16 bf16 x bf16 -> f32, accumulating into c
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 signed 4-bit codes k0..k15 (8 bytes, the even k in a byte's low
// nibble) -> 16 int8 in k order, 4 a word. Each nibble n becomes
// (n ^ 8) - 8 byte by byte (__vsub4 wraps within a byte), then the low
// and high nibbles of each byte are interleaved by byte permutes.
__device__ __forceinline__ void unpack_int4x16(uint2 w, uint32_t (&b)[4]) {
  const uint32_t m = 0x0F0F0F0Fu, s = 0x08080808u;
  const uint32_t lo0 = __vsub4((w.x & m) ^ s, s), hi0 = __vsub4(((w.x >> 4) & m) ^ s, s);
  const uint32_t lo1 = __vsub4((w.y & m) ^ s, s), hi1 = __vsub4(((w.y >> 4) & m) ^ s, s);
  b[0] = __byte_perm(lo0, hi0, 0x5140);
  b[1] = __byte_perm(lo0, hi0, 0x7362);
  b[2] = __byte_perm(lo1, hi1, 0x5140);
  b[3] = __byte_perm(lo1, hi1, 0x7362);
}

// bytes 2h and 2h + 1 of w, signed int8, as a bf16 pair (exact: |v| <= 127)
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w, int h) {
  const float f0 = static_cast<float>(static_cast<int8_t>(w >> (16 * h)));
  const float f1 = static_cast<float>(static_cast<int8_t>(w >> (16 * h + 8)));
  __nv_bfloat162 r = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<uint32_t*>(&r);
}

// two outputs of row m at columns n, n + 1 (the second only if n + 1 < N)
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, int m, int n, int N, float y0,
                                           float y1) {
  const size_t i = static_cast<size_t>(m) * N + n;
  if (n + 1 < N && (i & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(y0, y1);
  } else {
    out[i] = __float2bfloat16_rn(y0);
    if (n + 1 < N) out[i + 1] = __float2bfloat16_rn(y1);
  }
}

template <typename T>
__device__ __forceinline__ T load_or_zero(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const T*>(p)) : T{};
}

// the tile geometry: decode tiles (M <= 16) split K over 8 warps for 16
// columns; prefill tiles give each of 4 warps 16 rows of a 64 x 64 tile
struct DecodeTile {
  static constexpr int WM = 1, WK = 8, NT = 2;
};
struct PrefillTile {
  static constexpr int WM = 4, WK = 1, NT = 8;
};

struct Params {
  const void* x;         // (M, K) activations: int8 (K9) or bf16 (K10)
  const float* a_scale;  // (M,) per-row activation scales (K9), else null
  const uint8_t* w;      // (N, K) int8 or (N, K / 2) packed int4, K contiguous
  const float* scale;    // (N,) or grouped (K / group, N)
  const float* bias;     // (N,) or null
  __nv_bfloat16* out;    // (M, N)
  int M, N, K, group;    // group 0: per-channel scales
};

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// One tile of Op's product (see the top of this file). Op supplies the
// accumulator type `Acc`, a chunk of operands `Chunk<NT>`, `load` (one
// 64-wide k chunk of the lane's rows and columns, zeros past M and N),
// `mma` (the chunk's products into the accumulators), `kFoldChunks`
// (fold every chunk's sum, Acc being fp32) and `finish` (the per-row
// factor of the epilogue). Per channel: y = finish(sum) * scale[n];
// grouped: y = finish(sum_g acc_g * scale[g, n]); then + bias, to bf16.
// Every fp32 step is rounded on its own (no FMA contraction).
template <class Op, class Tile, bool GROUPED>
__global__ void __launch_bounds__(32 * Tile::WM * Tile::WK) gemm_kernel(const Params p) {
  constexpr int WM = Tile::WM, WK = Tile::WK, NT = Tile::NT;
  using Acc = typename Op::Acc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % WM, wk = warp / WM;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.y * 16 * WM + wm * 16 + g, r1 = r0 + 8;
  const int n0 = blockIdx.x * 8 * NT;
  constexpr bool FOLD = GROUPED || Op::kFoldChunks;  // sums that span units go to fp64
  const int per_unit = GROUPED ? p.group / CHUNK : 1;  // chunks a K unit
  const int units = p.K / (CHUNK * per_unit);
  const int mine = units > wk ? (units - wk + WK - 1) / WK : 0;  // this warp's units
  const int total = mine * per_unit;                              // and chunks

  Acc acc[NT][4];
  double f[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = Acc(0);
      f[i][j] = 0.0;
    }
  }
  typename Op::template Chunk<NT> cur, nxt;
  // chunk i of this warp: unit wk + (i / per_unit) WK, chunk i % per_unit of it
  if (total) Op::load(cur, p, r0, r1, n0, (wk * per_unit) * CHUNK, g, t);
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) {
      const int u = wk + ((i + 1) / per_unit) * WK;
      Op::load(nxt, p, r0, r1, n0, (u * per_unit + (i + 1) % per_unit) * CHUNK, g, t);
    }
    Op::mma(acc, cur);
    if (FOLD && (i + 1) % per_unit == 0) {  // a whole unit: fold it (with its group's scale)
      const int u = wk + (i / per_unit) * WK;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float term = to_float(acc[nt][j]);
          if (GROUPED) {
            const int c = n0 + nt * 8 + 2 * t + (j & 1);
            term = __fmul_rn(term, c < p.N ? p.scale[static_cast<size_t>(u) * p.N + c] : 0.0f);
          }
          f[nt][j] = __dadd_rn(f[nt][j], static_cast<double>(term));
          acc[nt][j] = Acc(0);
        }
      }
    }
    cur = nxt;
  }

  if constexpr (WK > 1) {  // the K slices' partials, summed by warp wk = 0 in wk order
    // fp64 partials (FOLD) or integer ones: exact, so the order is free
    __shared__ unsigned long long red[WM][WK - 1][NT * 4][32];
    if (wk > 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (FOLD) {
            red[wm][wk - 1][nt * 4 + j][lane] = __double_as_longlong(f[nt][j]);
          } else {
            red[wm][wk - 1][nt * 4 + j][lane] = static_cast<uint32_t>(acc[nt][j]);
          }
        }
      }
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int w = 0; w < WK - 1; ++w) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned long long v = red[wm][w][nt * 4 + j][lane];
          if constexpr (FOLD) {
            f[nt][j] = __dadd_rn(f[nt][j], __longlong_as_double(static_cast<long long>(v)));
          } else {  // int32 sums (K9 per channel), exact
            acc[nt][j] += static_cast<int>(static_cast<uint32_t>(v));
          }
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n0 + nt * 8 + 2 * t;
    if (c >= p.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      if (r >= p.M) continue;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * h + e, n = c + e;
        float v;
        if (GROUPED) {
          v = Op::finish(__double2float_rn(f[nt][j]), p, r);
        } else {
          const float sum = FOLD ? __double2float_rn(f[nt][j]) : to_float(acc[nt][j]);
          v = __fmul_rn(Op::finish(sum, p, r), n < p.N ? p.scale[n] : 0.0f);
        }
        if (p.bias != nullptr && n < p.N) v = __fadd_rn(v, p.bias[n]);
        y[e] = v;
      }
      store_pair(p.out, r, c, p.N, y[0], y[1]);
    }
  }
}

template <class Op, class Tile>
void run(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + 8 * Tile::NT - 1) / (8 * Tile::NT),
                  (p.M + 16 * Tile::WM - 1) / (16 * Tile::WM));
  const dim3 block(32 * Tile::WM * Tile::WK);
  if (p.group) {
    gemm_kernel<Op, Tile, true><<<grid, block, 0, stream>>>(p);
  } else {
    gemm_kernel<Op, Tile, false><<<grid, block, 0, stream>>>(p);
  }
}

// Launch Op's product on `stream`: the decode tiles at M <= 16, else the
// prefill tiles. Returns the launch's cudaError_t.
template <class Op>
int launch(const Params& p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.M <= 16) {
    run<Op, DecodeTile>(p, s);
  } else {
    run<Op, PrefillTile>(p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgemm
