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
//     weight) and the M activation rows of the same line (bulk copies, no
//     tensor map per call) into a ring of up to 6 stages (full / empty
//     mbarriers); rows and columns past the matrix arrive as zeros. Four
//     consumer warps, 16 columns each, run mma.sync.m16n8k32 from shared
//     memory while the next stages land: each lane loads 16 contiguous
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

#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// ------------------------------------------------------------------ decode
constexpr int DC_BN = 64;                 // weight rows (output columns) of a tile
constexpr int DC_LINE = 128;              // k bytes of a stage: one 128-byte line
constexpr int DC_MAX_M = 16;
constexpr int DC_CONSUMERS = 4;           // warps, 16 columns each
constexpr int DC_THREADS = 32 * (DC_CONSUMERS + 1);
constexpr int DC_MAX_STAGES = 6;
constexpr int DC_MAX_SEGMENTS = 3;
constexpr int DC_MAX_CLUSTER = 8;         // the portable cluster size
constexpr int DC_A_STRIDE = DC_LINE + 16;  // bytes an activation row: conflict-free loads
constexpr int DC_W_BYTES = DC_BN * DC_LINE;       // 8 KB, 1024-byte aligned (swizzle atoms)
constexpr int DC_A_BYTES = DC_MAX_M * DC_A_STRIDE;
// shared memory of a block: the ring, rank 0's partials (S x M x 64
// words, split launches only) and the barriers
constexpr size_t dc_smem_bytes(int stages, int split, int M) {
  return 1024 + static_cast<size_t>(stages) * (DC_W_BYTES + DC_A_BYTES) +
         (split > 1 ? static_cast<size_t>(split) * M * DC_BN * 4 : 0) +
         (2 * DC_MAX_STAGES + 1) * sizeof(uint64_t);
}

struct DecodeSegment {
  const float* scale;
  const float* bias;
  __nv_bfloat16* out;
  int N;
  int full_end;  // full-width column tiles of this segment and the ones before it
  int edge_end;  // all full-width tiles, then the edge tiles of this segment and the
                 // ones before it
};

struct DecodeParams {
  CUtensorMap w[DC_MAX_SEGMENTS];  // 64-byte aligned by its type
  DecodeSegment seg[DC_MAX_SEGMENTS];
  const int8_t* xq;
  const float* a_scale;
  int M, K, group;
  int tiles;       // column tiles over all segments
  int split;       // K slices of a column tile = the cluster size
  int unit_lines;  // lines of a split unit: whole scale groups
  int stages;
};

// the segment of column tile `tile` and the tile's first column in it. The
// tiles run every segment's full-width tiles in segment order, then the
// narrow edge tiles of ragged widths (`quant.DecodePlan.tile_order`): dealt
// round the SMs, the edge tiles land on the SMs that take an extra tile.
// The parameter loads are independent (each a constant-cache miss at first)
__device__ __forceinline__ void dc_segment(const DecodeParams& p, int tile, int& sg, int& n0,
                                           int& N) {
  const int f0 = p.seg[0].full_end, f1 = p.seg[1].full_end, f2 = p.seg[2].full_end;
  const int e0 = p.seg[0].edge_end, e1 = p.seg[1].edge_end;
  const bool edge = tile >= f2;
  sg = edge ? (tile >= e0) + (tile >= e1) : (tile >= f0) + (tile >= f1);
  N = sg == 0 ? p.seg[0].N : sg == 1 ? p.seg[1].N : p.seg[2].N;
  n0 = edge ? N / DC_BN * DC_BN : (tile - (sg == 0 ? 0 : sg == 1 ? f0 : f1)) * DC_BN;
}

// the producer warp's load of k-line `l` of the tile at column n0 of
// segment sg: 64 weight rows by TMA, the M activation rows by bulk copies
__device__ __forceinline__ void dc_load(const DecodeParams& p, int sg, int n0, int l,
                                        unsigned char* w, unsigned char* a, uint64_t* full,
                                        int lane) {
  const int k = l * DC_LINE;
  const int abytes = min(DC_LINE, p.K - k);
  if (lane == 0) hopper::mbar_arrive_expect_tx(full, DC_W_BYTES + p.M * abytes);
  __syncwarp();
  if (lane == 0) hopper::tma_load_2d(w, &p.w[sg], full, k, n0);
  if (lane < p.M) {
    hopper::bulk_load(a + lane * DC_A_STRIDE, p.xq + static_cast<size_t>(lane) * p.K + k, abytes,
                      full);
  }
}

// a consumer warp's products of k-line `l` (its 16 columns of the stage's
// 64), and with grouped scales the fold of each group that ends in it:
// acc[j][e] is row g + 8 (e / 2), column warp * 16 + 8 j + 2 t + e % 2
template <bool GROUPED>
__device__ __forceinline__ void dc_products(int (&acc)[2][4], float (&facc)[2][4],
                                            const unsigned char* a, const unsigned char* w,
                                            int l, int K, int M, int group, const float* scale,
                                            int N, int n0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunk0 = l * (DC_LINE / 64);  // 64-byte k-chunks before this line
  const int chunks = min(2, (K - l * DC_LINE) / 64);
  w += warp * 16 * DC_LINE;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h < chunks) {
      const int c = 4 * h + t;  // this lane's 16 bytes of the line
      const int4 zero = make_int4(0, 0, 0, 0);
      const int4 lo = g < M ? *reinterpret_cast<const int4*>(a + g * DC_A_STRIDE + 16 * c) : zero;
      const int4 hi =
          g + 8 < M ? *reinterpret_cast<const int4*>(a + (g + 8) * DC_A_STRIDE + 16 * c) : zero;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // row 8 j + g of this warp's 16; in the swizzle chunk c of a row r
        // sits at chunk c ^ (r % 8), and r % 8 == g
        const int4 b =
            *reinterpret_cast<const int4*>(w + (8 * j + g) * DC_LINE + 16 * (c ^ g));
        mma_s8(acc[j], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
        mma_s8(acc[j], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
      }
      if (GROUPED && (chunk0 + h + 1) % (group / 64) == 0) {  // a group ends
        const float* sc = scale + static_cast<size_t>((chunk0 + h) / (group / 64)) * N;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + warp * 16 + 8 * j + 2 * t;
          const float s0 = n < N ? sc[n] : 0.f;
          const float s1 = n + 1 < N ? sc[n + 1] : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[j][e] += static_cast<float>(acc[j][e]) * ((e & 1) ? s1 : s0);
            acc[j][e] = 0;
          }
        }
      }
    }
  }
}

// Split launches (p.split > 1): one column tile a cluster of p.split
// blocks, block `rank` summing K slice `rank`; the partial rows go to rank
// 0, which adds them and writes the tile.
template <bool GROUPED>
__global__ void __launch_bounds__(DC_THREADS)
    w8a8_decode_split_kernel(const __grid_constant__ DecodeParams p) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int stages = p.stages, S = p.split, M = p.M, K = p.K;
  unsigned char* wring = smem;
  unsigned char* aring = smem + stages * DC_W_BYTES;
  uint32_t* red = reinterpret_cast<uint32_t*>(aring + stages * DC_A_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + S * M * DC_BN);
  uint64_t* empty = full + DC_MAX_STAGES;
  uint64_t* red_full = empty + DC_MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(blockIdx.x % S);  // the rank in the cluster
  int sg, n0, N;
  dc_segment(p, blockIdx.x / S, sg, n0, N);

  // this block's lines: split units dealt evenly over the cluster
  const int lines = (K + DC_LINE - 1) / DC_LINE;
  const int units = (lines + p.unit_lines - 1) / p.unit_lines;
  const int l0 = min(lines, rank * units / S * p.unit_lines);
  const int l1 = min(lines, (rank + 1) * units / S * p.unit_lines);
  const int nl = l1 - l0;

  if (warp == 0) {  // one barrier a lane
    if (lane < stages) {
      mbar_init(&full[lane], 1);
      mbar_init(&empty[lane], DC_CONSUMERS);
    } else if (lane == DC_MAX_STAGES) {
      mbar_init(red_full, 1);
      // rank 0 receives every block's partial rows: S x M x 64 words
      if (rank == 0) mbar_arrive_expect_tx(red_full, S * M * DC_BN * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();
  cluster_arrive_relaxed();  // rank 0's barrier is ready; waited for before the partials go

  if (warp == DC_CONSUMERS) {
    // ------------------------------------------------------------ producer
    for (int i = 0; i < nl; ++i) {
      const int s = i % stages;
      if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
      dc_load(p, sg, n0, l0 + i, wring + s * DC_W_BYTES, aring + s * DC_A_BYTES, &full[s], lane);
    }
    cluster_wait();
  } else {
    // ---------------------------------------------------------- consumers
    int acc[2][4] = {};
    float facc[2][4] = {};
    const float* scale = p.seg[sg].scale;
    for (int i = 0; i < nl; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      dc_products<GROUPED>(acc, facc, aring + s * DC_A_BYTES, wring + s * DC_W_BYTES, l0 + i, K,
                           M, p.group, scale, N, n0);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // this block's partial rows (< M) into rank 0's shared memory
    cluster_wait();
    const int g = lane >> 2, t = lane & 3;
    const uint32_t bar = cluster_addr(red_full, 0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = g + 8 * hh;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t x = GROUPED ? __float_as_uint(facc[j][2 * hh])
                                   : static_cast<uint32_t>(acc[j][2 * hh]);
        const uint32_t y = GROUPED ? __float_as_uint(facc[j][2 * hh + 1])
                                   : static_cast<uint32_t>(acc[j][2 * hh + 1]);
        const int col = warp * 16 + 8 * j + 2 * t;
        st_async_v2(cluster_addr(red + (rank * M + row) * DC_BN + col, 0), x, y, bar);
      }
    }
  }
  if (rank != 0) return;

  // rank 0: the tile's outputs in column pairs over the block's threads,
  // each the sum of the S partials in rank order; the epilogue's operands
  // are loaded while the partials arrive
  const DecodeSegment& seg = p.seg[sg];
  constexpr int kPairs = DC_BN / 2;
  constexpr int kMaxPerThread = (DC_MAX_M * kPairs + DC_THREADS - 1) / DC_THREADS;
  float as[kMaxPerThread], sc[kMaxPerThread][2], bi[kMaxPerThread][2];
#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) {
    const int q = tid + u * DC_THREADS;
    const int m = min(q / kPairs, M - 1), n = n0 + 2 * (q % kPairs);
    as[u] = p.a_scale[m];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ne = min(n + e, N - 1);
      sc[u][e] = GROUPED ? 0.f : seg.scale[ne];
      bi[u][e] = seg.bias != nullptr ? seg.bias[ne] : 0.f;
    }
  }
  mbar_wait(red_full, 0);
#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) {
    const int q = tid + u * DC_THREADS;
    const int m = q / kPairs, c = 2 * (q % kPairs);
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    float y[2];
    if (GROUPED) {
      float sum[2] = {0.f, 0.f};
      for (int r = 0; r < S; ++r) {
        const uint2 v = *reinterpret_cast<const uint2*>(red + (r * M + m) * DC_BN + c);
        sum[0] += __uint_as_float(v.x);
        sum[1] += __uint_as_float(v.y);
      }
      y[0] = __fmul_rn(sum[0], as[u]);
      y[1] = __fmul_rn(sum[1], as[u]);
    } else {
      int sum[2] = {0, 0};
      for (int r = 0; r < S; ++r) {
        const uint2 v = *reinterpret_cast<const uint2*>(red + (r * M + m) * DC_BN + c);
        sum[0] += static_cast<int>(v.x);
        sum[1] += static_cast<int>(v.y);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        y[e] = __fmul_rn(__fmul_rn(__int2float_rn(sum[e]), as[u]), sc[u][e]);
      }
    }
    if (seg.bias != nullptr) {
      y[0] = __fadd_rn(y[0], bi[u][0]);
      y[1] = __fadd_rn(y[1], bi[u][1]);
    }
    store_pair(seg.out, m, n, N, y[0], y[1]);
  }
}

// Whole-K launches (p.split == 1): persistent blocks, block b walking the
// column tiles b, b + gridDim.x, ... (in `dc_segment`'s order); the ring runs on from one tile to
// the next, and each consumer warp writes its 16 columns from registers.
template <bool GROUPED>
__global__ void __launch_bounds__(DC_THREADS)
    w8a8_decode_stream_kernel(const __grid_constant__ DecodeParams p) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int stages = p.stages, M = p.M, K = p.K;
  unsigned char* wring = smem;
  unsigned char* aring = smem + stages * DC_W_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(aring + stages * DC_A_BYTES);
  uint64_t* empty = full + DC_MAX_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lines = (K + DC_LINE - 1) / DC_LINE;

  if (warp == 0) {
    if (lane < stages) {
      mbar_init(&full[lane], 1);
      mbar_init(&empty[lane], DC_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == DC_CONSUMERS) {
    // ------------------------------------------------------------ producer
    int i = 0;  // lines through the ring
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      int sg, n0, N;
      dc_segment(p, tile, sg, n0, N);
      for (int l = 0; l < lines; ++l, ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
        dc_load(p, sg, n0, l, wring + s * DC_W_BYTES, aring + s * DC_A_BYTES, &full[s], lane);
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  const int g = lane >> 2, t = lane & 3;
  const float as_lo = p.a_scale[min(g, M - 1)], as_hi = p.a_scale[min(g + 8, M - 1)];
  int i = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int sg, n0, N;
    dc_segment(p, tile, sg, n0, N);
    const DecodeSegment& seg = p.seg[sg];
    // the epilogue's operands of this warp's columns, loaded ahead
    float sc[2][2], bi[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ne = min(n0 + warp * 16 + 8 * j + 2 * t + e, N - 1);
        sc[j][e] = GROUPED ? 0.f : seg.scale[ne];
        bi[j][e] = seg.bias != nullptr ? seg.bias[ne] : 0.f;
      }
    int acc[2][4] = {};
    float facc[2][4] = {};
    for (int l = 0; l < lines; ++l, ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      dc_products<GROUPED>(acc, facc, aring + s * DC_A_BYTES, wring + s * DC_W_BYTES, l, K, M,
                           p.group, seg.scale, N, n0);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = g + 8 * hh;
      if (m >= M) continue;
      const float as = hh ? as_hi : as_lo;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + warp * 16 + 8 * j + 2 * t;
        if (n >= N) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = GROUPED ? __fmul_rn(facc[j][2 * hh + e], as)
                         : __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * hh + e]), as),
                                     sc[j][e]);
          if (seg.bias != nullptr) y[e] = __fadd_rn(y[e], bi[j][e]);
        }
        store_pair(seg.out, m, n, N, y[0], y[1]);
      }
    }
  }
}

// the tensor map of a weight (N, K) in 64-row boxes of 128-byte lines,
// built once per (pointer, N, K): weights live as long as their module
cudaError_t weight_map(CUtensorMap* map, const void* w, int N, int K) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(w, N, K);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const cudaError_t err = hopper::int8_map(map, w, N, K, DC_BN);
  if (err == cudaSuccess) {
    if (cache.size() >= 4096) cache.clear();  // freed weights' entries
    cache.emplace(key, *map);
  }
  return err;
}

template <bool GROUPED>
cudaError_t launch_decode(const DecodeParams& p, int blocks, cudaStream_t stream) {
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    const int most = static_cast<int>(dc_smem_bytes(DC_MAX_STAGES, DC_MAX_CLUSTER, DC_MAX_M));
    err = cudaFuncSetAttribute(w8a8_decode_split_kernel<GROUPED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(w8a8_decode_stream_kernel<GROUPED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    }
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(DC_THREADS);
  cfg.dynamicSmemBytes = dc_smem_bytes(p.stages, p.split, p.M);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  err = p.split > 1 ? cudaLaunchKernelEx(&cfg, w8a8_decode_split_kernel<GROUPED>, p)
                    : cudaLaunchKernelEx(&cfg, w8a8_decode_stream_kernel<GROUPED>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
        store_pair(out, m, n, N, y[0], y[1]);
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

// Prefill tiles (M > 16). xq (M, K) int8, a_scale (M,) fp32, weight_q (N,
// K) int8, scale (N,) fp32 or, with group > 0, (K / group, N) fp32; bias
// (N,) fp32 or null; out (M, N) bf16. K % 64 == 0 and group % 64 == 0, xq
// and weight_q 16-byte aligned (checked by the wrapper). Returns a
// cudaError_t (0 = launched).
extern "C" int w8a8_gemm_prefill(const void* xq, const void* a_scale, const void* weight_q,
                                 const void* scale, const void* bias, void* out, int M, int N,
                                 int K, int group, void* stream) {
  return static_cast<int>(prefill(static_cast<const int8_t*>(xq),
                                  static_cast<const float*>(a_scale),
                                  static_cast<const int8_t*>(weight_q),
                                  static_cast<const float*>(scale),
                                  static_cast<const float*>(bias),
                                  static_cast<__nv_bfloat16*>(out), M, N, K, group,
                                  static_cast<cudaStream_t>(stream)));
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
  if (M < 1 || M > DC_MAX_M || nseg < 1 || nseg > DC_MAX_SEGMENTS || block_n != DC_BN ||
      split < 1 || split > DC_MAX_CLUSTER || unit_lines < 1 || stages < 1 ||
      stages > DC_MAX_STAGES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* w[DC_MAX_SEGMENTS] = {w0, w1, w2};
  const void* sc[DC_MAX_SEGMENTS] = {s0, s1, s2};
  const void* b[DC_MAX_SEGMENTS] = {b0, b1, b2};
  void* o[DC_MAX_SEGMENTS] = {o0, o1, o2};
  const int n[DC_MAX_SEGMENTS] = {N0, N1, N2};
  DecodeParams p;
  int full = 0;
  for (int i = 0; i < DC_MAX_SEGMENTS; ++i) {
    if (i < nseg) {
      if (n[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
      const cudaError_t err = weight_map(&p.w[i], w[i], n[i], K);
      if (err != cudaSuccess) return static_cast<int>(err);
      full += n[i] / DC_BN;
    }
    p.seg[i].scale = static_cast<const float*>(sc[i]);
    p.seg[i].bias = static_cast<const float*>(b[i]);
    p.seg[i].out = static_cast<__nv_bfloat16*>(o[i]);
    p.seg[i].N = n[i];
    p.seg[i].full_end = full;
  }
  int tiles = full;
  for (int i = 0; i < DC_MAX_SEGMENTS; ++i) {
    tiles += i < nseg && n[i] % DC_BN != 0;
    p.seg[i].edge_end = tiles;
  }
  if (split > 1 ? blocks != tiles * split : blocks < 1 || blocks > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.xq = static_cast<const int8_t*>(xq);
  p.a_scale = static_cast<const float*>(a_scale);
  p.M = M, p.K = K, p.group = group, p.tiles = tiles;
  p.split = split, p.unit_lines = unit_lines, p.stages = stages;
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(group ? launch_decode<true>(p, blocks, s)
                                : launch_decode<false>(p, blocks, s));
}
