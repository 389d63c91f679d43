// K8f: NextDiT's SwiGLU feed-forward input, the gate and up products with
// the SiLU and the product as their epilogue; CUDA C++ for sm_90a.
//
//   out = bf16( silu_xla(bf16(x W1^T)) * bf16(x W3^T) )
//
// x (M, K) bf16; W1, W3 (N, K) bf16 (`linear_1.weight`, `linear_3.weight`
// in their nn.Linear layout); out (M, N) bf16. Replaces, on the System-1
// inference path, the XLA fusion of internnav_tpu/model/basemodel/
// internvla_n1/nextdit.py `LuminaFeedForward` (:144-146): two bf16 dots
// (fp32 sums, bf16 outputs) and `nn.silu(g) * u`, which the port ran as two
// cuBLAS products and K8, with both (M, N) intermediates written to device
// memory and read back. The plain version is `ops/activations.
// swiglu_gemm_reference`: silu_mul_reference(F.linear(x, W1), F.linear(x,
// W3)). The sums are fp32 in another order than cuBLAS's, so a product can
// round to the neighbouring bf16 value; the SiLU and the product are the
// plain version's op for op (`silu_xla`, then one rounding).
//
// What bounds it (NextDiT: K = 384, N = 1,024; M = 32 samples x 32 tokens
// a stream): at M = 1,024 the 1.6 GFLOP at the 989 TFLOP/s bf16 peak take
// 1.63 us and the 4.4 MB of x, W1, W3 and out 1.33 us at 3.35 TB/s; at
// 3,072 rows and above the flops. Two things cost more than either on this
// card: the SiLU epilogue (an expf, a reciprocal and five bf16 roundings
// an output, all on the CUDA cores) and the L2 traffic of re-reading x for
// every 64 columns and W for every 128 rows (302 MB at M = 12,288).
//
// Design:
// - Tiles. A block computes 128 rows x 64 output columns, holding a gate
//   tile and an up tile of the same 64 columns: 128 blocks at M = N =
//   1,024, one wave on 132 SMs. Blocks run along M first, so the blocks
//   that share a weight panel run together and read it from device memory
//   once.
// - Pipeline. One producer warp's first thread streams, per 64-wide k
//   stage, the x tile (128 rows) and the W1 and W3 tiles (64 rows each,
//   landed back to back) by TMA into a ring of STAGES = 3 stages of 32 KB
//   (full / empty mbarriers). Rows past M, rows past N and k past K arrive
//   as zeros.
// - Two blocks an SM. 97 KB of shared memory and 90 registers a thread
//   (no register reallocation: the producer is one warp) let two blocks
//   share an SM, so one block's epilogue runs while the other's loads and
//   products do. The first design, the whole of K resident in 6 stages,
//   one block an SM and the SiLU's reciprocal by IEEE division, ran load,
//   products and epilogue of each block one after the other: 0.1015 ms at
//   M = 12,288 against this one's 0.0605 (chip_smoke.py's K8f row, NVIDIA
//   H100 80GB HBM3 at 700 W).
// - Products. Two consumer warpgroups, each owning 64 rows, issue wgmma
//   m64n128k16 with both operands K-major in shared memory: the B operand
//   is W1's 64 rows followed by W3's, so one product yields the gate
//   (accumulator columns 0-63) and the up (64-127) of the same output
//   columns in the same thread. fp32 accumulators, 64 a thread.
// - Epilogue in registers: each accumulator rounded to bf16 (XLA's bf16
//   dot output), `silu_xla` of the gate (its reciprocal by rcp.approx,
//   exact after the bf16 rounding: silu_xla.cuh), the product with up
//   (`__fmul_rn`), rounded, stored; rows past M and columns past N are not
//   stored.
// The wrapper (`activations.swiglu_gemm_cuda`) checks dtypes, shapes,
// contiguity and alignment; K must be a multiple of 8 (TMA's 16-byte row
// stride).

#include "hopper.cuh"
#include "silu_xla.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                             // rows of a tile: two warpgroups of 64
constexpr int BN = 64;                              // output columns of a tile
constexpr int BK = 64;                              // k of a stage: one 128-byte line
constexpr int STAGES = 3;                           // the ring's depth
constexpr int THREADS = 2 * 128 + 32;               // two consumer warpgroups, a producer warp
constexpr int X_BYTES = BM * BK * 2;                // 16 KB
constexpr int W_BYTES = BN * BK * 2;                // 8 KB each of W1, W3
constexpr int STAGE_BYTES = X_BYTES + 2 * W_BYTES;  // 32 KB
constexpr size_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
constexpr int BLOCKS_PER_SM = 2;                    // 2 x 97 KB of the SM's 227 KB

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    swiglu_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w1,
                       const __grid_constant__ CUtensorMap tm_w3,
                       __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt = (K + BK - 1) / BK;  // stages

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
    if (tid == 256) {
      for (int i = 0; i < kt; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        unsigned char* stage = smem + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(stage, &tm_x, &full[s], i * BK, m0);
        tma_load_2d(stage + X_BYTES, &tm_w1, &full[s], i * BK, n0);
        tma_load_2d(stage + X_BYTES + W_BYTES, &tm_w3, &full[s], i * BK, n0);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    const int wg = tid >> 7;
    // acc[4 j + e]: row 16 warp + lane / 4 + 8 (e / 2) of the warpgroup's
    // 64, column 8 j + 2 (lane % 4) + e % 2 of the B tile: the gate's
    // column c at j < 8, the up's column c at j + 8
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int i = 0; i < kt; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * STAGE_BYTES + wg * 64 * 128);
      const uint32_t b = smem_u32(smem + s * STAGE_BYTES + X_BYTES);
      wgmma_fence();
      // the k-steps past K read TMA's zero fill: all 4 run
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k16_ss(acc, desc_kmajor(a, kk), desc_kmajor(b, kk), i > 0 || kk > 0);
      }
      wgmma_commit();
      // the previous stage's products are done: release it
      wgmma_wait<1>();
      fence_operands(acc);
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);

    const int t = lane & 3;
    const int row0 = m0 + wg * 64 + 16 * ((tid & 127) >> 5) + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n >= N) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g = xla::bf16_round(acc[4 * j + 2 * h + e]);
          const float u = xla::bf16_round(acc[4 * (j + 8) + 2 * h + e]);
          y[e] = __fmul_rn(xla::silu_xla(g), u);
        }
        // a bf16 pair where its address is 4-byte aligned, else one at a time
        const size_t idx = static_cast<size_t>(m) * N + n;
        if (n + 1 < N && (idx & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(y[0], y[1]);
        } else {
          out[idx] = __float2bfloat16_rn(y[0]);
          if (n + 1 < N) out[idx + 1] = __float2bfloat16_rn(y[1]);
        }
      }
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. x (M, K), w1 and w3 (N, K), out (M, N),
// all bf16, contiguous and 16-byte aligned; K a multiple of 8. Returns a
// cudaError_t (0 = launched).
extern "C" int swiglu_gemm_bf16(const void* x, const void* w1, const void* w3, void* out, int M,
                                int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 8 || K % 8 != 0 || (N + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(swiglu_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tx, tw1, tw3;
  err = bf16_map(&tx, x, M, K, BM);
  if (err == cudaSuccess) err = bf16_map(&tw1, w1, N, K, BN);
  if (err == cudaSuccess) err = bf16_map(&tw3, w3, N, K, BN);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  swiglu_gemm_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tx, tw1, tw3, static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
