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
// Two kernels, by M:
// - Decode (M <= 16): bound by the weight bytes. One block of 4 warps
//   computes a 16 x 16 output tile; the 4 warps split K (in whole scale
//   groups) and their exact int32 partials are summed in shared memory.
//   Each lane loads 16 contiguous bytes of a weight row and of each
//   activation row straight into mma.sync.m16n8k32 fragments: the k order
//   inside a 64-wide chunk is permuted the same way for A and B, which
//   leaves the dot product unchanged. 4 chunks of loads are in flight per
//   warp.
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

#include "hopper.cuh"

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


// ------------------------------------------------------------------ prefill
constexpr int PF_BM = 128;             // rows of a tile: two consumer warpgroups of 64
constexpr int PF_BK = 128;             // k values (bytes) of a stage: one 128-byte line
constexpr int PF_THREADS = 3 * 128;    // two consumer warpgroups and a producer warpgroup
constexpr int PF_PRODUCER_REGS = 40;
constexpr int PF_CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65,536

template <int BN>
__host__ __device__ constexpr int pf_stages() {
  return BN == 256 ? 4 : 5;
}

template <int BN>
constexpr size_t pf_smem_bytes() {
  return 1024 + static_cast<size_t>(pf_stages<BN>()) * (PF_BM + BN) * PF_BK +
         2 * pf_stages<BN>() * sizeof(uint64_t);
}

template <int BN>
__device__ __forceinline__ void pf_wgmma(int (&d)[BN / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (BN == 256) {
    hopper::wgmma_m64n256k32_s8(d, a, b, accumulate);
  } else {
    hopper::wgmma_m64n128k32_s8(d, a, b, accumulate);
  }
}

template <int BN, bool GROUPED>
__global__ void __launch_bounds__(PF_THREADS, 1)
    w8a8_prefill_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const float* __restrict__ a_scale, const float* __restrict__ scale,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M,
                        int N, int K, int group) {
  using namespace hopper;
  constexpr int STAGES = pf_stages<BN>();
  constexpr int A_BYTES = PF_BM * PF_BK, STAGE_BYTES = (PF_BM + BN) * PF_BK;
  constexpr int NACC = BN / 2;  // s32 accumulators a thread holds for its m64nBN product
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int m0 = blockIdx.x * PF_BM, n0 = blockIdx.y * BN;
  const int ksteps = K / 32;  // 32-byte k-steps; K % 64 == 0
  const int kt = (ksteps + 3) / 4;  // stages

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------------------ producer
    reg_dealloc<PF_PRODUCER_REGS>();
    if (tid == 256) {
      for (int i = 0; i < kt; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(smem + s * STAGE_BYTES, &tm_x, &full[s], i * PF_BK, m0);
        tma_load_2d(smem + s * STAGE_BYTES + A_BYTES, &tm_w, &full[s], i * PF_BK, n0);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    reg_alloc<PF_CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int steps_per_group = GROUPED ? group / 32 : 0;
    const int t = lane & 3;
    // one warp's release of stage s
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    int acc[NACC];
    float facc[GROUPED ? NACC : 1];
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = 0;
    if constexpr (GROUPED) {
#pragma unroll
      for (int e = 0; e < NACC; ++e) facc[e] = 0.f;
    }

    for (int i = 0; i < kt; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint32_t a_addr = smem_u32(smem + s * STAGE_BYTES + wg * 64 * PF_BK);
      const uint32_t b_addr = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
      if constexpr (!GROUPED) {
        wgmma_fence();
        // the k-steps past K read TMA's zero fill: all 4 run
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pf_wgmma<BN>(acc, desc_kmajor_s8(a_addr, kk), desc_kmajor_s8(b_addr, kk),
                       i > 0 || kk > 0);
        }
        wgmma_commit();
        // the previous stage's products are done: release it
        wgmma_wait<1>();
        fence_operands(acc);
        if (i > 0) release((i - 1) % STAGES);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ks = 4 * i + kk;
          if (ks < ksteps) {
            wgmma_fence();
            pf_wgmma<BN>(acc, desc_kmajor_s8(a_addr, kk), desc_kmajor_s8(b_addr, kk),
                         ks % steps_per_group != 0);
            wgmma_commit();
            if ((ks + 1) % steps_per_group == 0) {  // a group ends: fold it in fp32
              wgmma_wait<0>();
              fence_operands(acc);
              const float* sg = scale + static_cast<size_t>(ks / steps_per_group) * N;
#pragma unroll
              for (int j = 0; j < BN / 8; ++j) {
                const int n = n0 + 8 * j + 2 * t;
                const float s0 = n < N ? sg[n] : 0.f;
                const float s1 = n + 1 < N ? sg[n + 1] : 0.f;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  facc[4 * j + e] += static_cast<float>(acc[4 * j + e]) * ((e & 1) ? s1 : s0);
                }
              }
            }
          }
        }
        wgmma_wait<0>();
        fence_operands(acc);
        release(s);
      }
    }
    if constexpr (!GROUPED) {
      wgmma_wait<0>();
      fence_operands(acc);
    }

    // epilogue: thread holds rows row0 + {0, 8} and, per 8-column block j,
    // columns 8 j + 2 t + {0, 1}: acc[4 j + 2 h + e] is row row0 + 8 h
    const int row0 = m0 + wg * 64 + 16 * ((tid & 127) >> 5) + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= M) continue;
      const float as = a_scale[m];
      __nv_bfloat16* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n >= N) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = min(n + e, N - 1);
          if constexpr (GROUPED) {
            y[e] = __fmul_rn(facc[4 * j + 2 * h + e], as);
          } else {
            y[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), as), scale[c]);
          }
          if (bias != nullptr) y[e] = __fadd_rn(y[e], bias[c]);
        }
        if (n + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(y[0], y[1]);
        } else {
          orow[n] = __float2bfloat16_rn(y[0]);
        }
      }
    }
  }
}

template <int BN, bool GROUPED>
cudaError_t launch_prefill(const CUtensorMap& tx, const CUtensorMap& tw, const float* a_scale,
                           const float* scale, const float* bias, __nv_bfloat16* out, int M,
                           int N, int K, int group, cudaStream_t stream) {
  const size_t smem = pf_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(w8a8_prefill_kernel<BN, GROUPED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + PF_BM - 1) / PF_BM, (N + BN - 1) / BN);
  w8a8_prefill_kernel<BN, GROUPED>
      <<<grid, PF_THREADS, smem, stream>>>(tx, tw, a_scale, scale, bias, out, M, N, K, group);
  return cudaGetLastError();
}

// the prefill tiles' tensor maps and launch: 128 x 256 output tiles where
// N > 1024 (each activation line read for twice the outputs), else 128 x
// 128 (256-wide tiles leave SMs idle below ~1,000 columns); grouped scales
// take 128 (their fp32 sums double the accumulator registers)
cudaError_t prefill(const int8_t* x, const float* a, const int8_t* w, const float* sc,
                    const float* b, __nv_bfloat16* o, int M, int N, int K, int group,
                    cudaStream_t s) {
  const int block_n = !group && N > 1024 ? 256 : 128;
  CUtensorMap tx, tw;
  cudaError_t err = hopper::int8_map(&tx, x, M, K, PF_BM);
  if (err == cudaSuccess) err = hopper::int8_map(&tw, w, N, K, block_n);
  if (err != cudaSuccess) return err;
  if (group) return launch_prefill<128, true>(tx, tw, a, sc, b, o, M, N, K, group, s);
  if (block_n == 256) return launch_prefill<256, false>(tx, tw, a, sc, b, o, M, N, K, 0, s);
  return launch_prefill<128, false>(tx, tw, a, sc, b, o, M, N, K, 0, s);
}

}  // namespace

// xq (M, K) int8, a_scale (M,) fp32, weight_q (N, K) int8, scale (N,) fp32
// or, with group > 0, (K / group, N) fp32; bias (N,) fp32 or null; out
// (M, N) bf16. K % 64 == 0 and group % 64 == 0, xq and weight_q 16-byte
// aligned (checked by the wrapper). Returns a cudaError_t (0 = launched).
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
  if (M <= 16) {  // decode: 16 columns a block, 4 chunks of loads in flight
    launch<1, 2, 4>(x, a, w, sc, b, o, M, N, K, group, s);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(prefill(x, a, w, sc, b, o, M, N, K, group, s));
}
