// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// split cluster barriers and stores into a cluster block's shared memory,
// TMA tile and bulk loads, 128-byte-swizzled wgmma descriptors, the wgmma
// products the flash-attention kernels and the SwiGLU GEMM (bf16) and the
// W8A8 GEMM (s8) issue, register reallocation, the live-tile list, the
// accumulator store, and host-side tensor maps (bf16 tiles and rows of
// 128-byte lines; int8 rows of 128-byte lines).
//
// Layout convention. A tile is 64 rows of up to 128 bf16 columns, loaded by
// TMA as two boxes of 64 x 64 elements (box 0: columns 0-63, box 1: 64-127,
// 8 KB each, 1024-byte aligned) with CU_TENSOR_MAP_SWIZZLE_128B: each row is
// one 128-byte line and 8 rows form one 1024-byte swizzle atom. Columns past
// the tensor's last one, and rows past its last row, arrive as zeros.
// Such a tile serves wgmma in two ways:
// - K-major (the columns are the reduction axis, e.g. Q in S = Q K^T):
//   k-step kk (16 columns) starts at box kk / 4, byte (kk % 4) * 32 of the
//   line; the 8-row groups are SBO = 1024 bytes apart;
// - MN-major (the rows are the reduction axis, e.g. K in dQ = dS K): k-step
//   kk (16 rows) starts 2048 * kk bytes in; the two 64-column boxes are
//   LBO = 8192 bytes apart, the 8-row groups SBO = 1024 bytes.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int TILE_COLS = 128;             // head dim, zero-padded
constexpr int BOX_BYTES = 64 * 64 * 2;     // one 64 x 64 bf16 box
constexpr int TILE_BYTES = 2 * BOX_BYTES;  // 64 x 128 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of asynchronous copies on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// arrive once (a consumer releasing a ring stage)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase with parity `parity` has completed; a
// phase that never completes (a lost copy) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

// --------------------------------------------------------------- clusters
// split cluster barrier: arrive early, wait (acquire) where needed; every
// thread of every block of the cluster arrives once. The arrive is relaxed:
// it orders only what a fence before it (fence_barrier_init) released
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of this block's shared `p` in block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// store two words into a cluster block's shared memory (address from
// cluster_addr) and count their 8 bytes on its mbarrier `bar` (ditto)
__device__ __forceinline__ void st_async_v2(uint32_t addr, uint32_t x, uint32_t y,
                                            uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];\n"
               :: "r"(addr), "r"(x), "r"(y), "r"(bar)
               : "memory");
}

// ------------------------------------------------------------------- TMA
// one box of a 3-D tensor map at coordinates (x, y, z), innermost first
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// one box of a 2-D tensor map at coordinates (x, y), innermost first
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// a 64 x 128 tile: both 64-column boxes at rows y.. of slice z
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int y, int z) {
  tma_load_3d(dst, map, bar, 0, y, z);
  tma_load_3d(static_cast<char*>(dst) + BOX_BYTES, map, bar, 64, y, z);
}

// `bytes` (a multiple of 16) of contiguous global memory, 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ----------------------------------------------------------------- wgmma
// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// k-step kk of a tile used K-major (64 rows x 16 columns)
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024);
}

// k-step kk of a tile used MN-major (16 rows x 128 columns)
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_F32(o)                                                                     \
  HOPPER_F4(o + 0), HOPPER_F4(o + 4), HOPPER_F4(o + 8), HOPPER_F4(o + 12), HOPPER_F4(o + 16), \
      HOPPER_F4(o + 20), HOPPER_F4(o + 24), HOPPER_F4(o + 28)

// d (64 x 64 fp32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_F32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128 fp32) (+)= A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_F32(0), HOPPER_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64 fp32) (+)= A (64 x 16, registers) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HOPPER_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128 fp32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_F32(0), HOPPER_F32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef HOPPER_F32
#undef HOPPER_F4

// int8 products (the W8A8 GEMM). 8-bit wgmma takes both operands K-major
// from shared memory. An int8 tile is rows of one 128-byte line (128 k
// values, `int8_map`), so k-step kk (32 values = 32 bytes) starts at byte
// 32 kk of the line and the 8-row groups are SBO = 1024 bytes apart: the
// K-major descriptors of the bf16 tiles, with 32-byte k-steps.
__device__ __forceinline__ uint64_t desc_kmajor_s8(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 32, 16, 1024);
}

#define HOPPER_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define HOPPER_R32(o)                                                                     \
  HOPPER_R4(o + 0), HOPPER_R4(o + 4), HOPPER_R4(o + 8), HOPPER_R4(o + 12), HOPPER_R4(o + 16), \
      HOPPER_R4(o + 20), HOPPER_R4(o + 24), HOPPER_R4(o + 28)

// d (64 x 128 s32) (+)= A (64 x 32 s8, smem, K-major) * B (32 x 128 s8, smem, K-major)
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : HOPPER_R32(0), HOPPER_R32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 256 s32) (+)= A (64 x 32 s8, smem, K-major) * B (32 x 256 s8, smem, K-major)
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : HOPPER_R32(0), HOPPER_R32(32), HOPPER_R32(64), HOPPER_R32(96)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#undef HOPPER_R32
#undef HOPPER_R4

// --------------------------------------------------- register reallocation
// Every warp of a warpgroup executes these together. A producer warpgroup
// gives registers back; the consumer warpgroups take them.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Accumulator layout of an m64nN product (and of each thread's fragments):
// thread t of the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 + {0, 8}
// and, for each 8-column block j, columns 8 j + 2 (t % 4) + {0, 1}:
// d[4 j + e] is row + 8 * (e / 2), column 8 j + 2 (t % 4) + e % 2.
// A register fragment for k-step kk takes accumulator blocks 2 kk, 2 kk + 1.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A operand of k-step kk from a tile in shared memory
// (K-major, 128-byte swizzle; the layout convention above): this thread's
// rows 16 (t / 32) + (t % 32) / 4 + {0, 8}, columns 16 kk + 2 (t % 4) +
// {0, 1, 8, 9}. In the swizzle, 16-byte chunk c of row r sits at chunk
// c ^ (r % 8) of the row's 128-byte line.
__device__ __forceinline__ void smem_to_a(uint32_t (&a)[4], const unsigned char* tile, int kk) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const unsigned char* line = tile + (kk >> 2) * BOX_BYTES + row * 128;
  const int c0 = (kk & 3) * 2;
  const int byte = 4 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // columns 16 kk + {0..7}, then + {8..15}
    const unsigned char* p = line + (((c0 + h) ^ (row & 7)) << 4) + byte;
    a[2 * h] = *reinterpret_cast<const uint32_t*>(p);
    a[2 * h + 1] = *reinterpret_cast<const uint32_t*>(p + 8 * 128);
  }
}

// 2^x on the special-function unit (flush-to-zero; -inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// rows row0 + {0, 8} of a (rows, D) bf16 matrix from an m64n128 fp32
// accumulator; rows at or past `limit` and columns at or past D skipped
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, const float (&acc)[64], int row0,
                                          int limit, int D) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    __nv_bfloat16* out = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(acc[4 * j + 2 * r],
                                                            acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ tile skipping
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Two tiles' segment ranges (`tile_segment_ranges` in ops/flash_attention.py:
// [lo, hi] over the ids >= 0, then [lo, hi] over the ids < 0) overlap: only
// then can the tiles hold a query and a key with equal ids.
__device__ __forceinline__ bool ranges_overlap(int4 a, int4 b) {
  return max(a.x, b.x) <= min(a.y, b.y) || max(a.z, b.z) <= min(a.w, b.w);
}

// The live tiles i in [begin, end), in order, into `list`: live(i) returns
// the entry to store for tile i (i itself, or i with flags in its high
// bits), or -1 to drop the tile; returns their count. Called by all
// THREADS threads of the block (it holds __syncthreads), or with
// THREADS = 32 by one warp alone (__syncwarp); `warp_counts` has
// THREADS / 32 entries.
template <int THREADS, typename Live>
__device__ int build_live_list(int* list, int* warp_counts, int begin, int end, Live live) {
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) % (THREADS / 32);
  auto sync = [] {
    if constexpr (THREADS == 32) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  };
  int count = 0;
  for (int base = begin; base < end; base += THREADS) {
    const int i = base + static_cast<int>(threadIdx.x % THREADS);
    const int entry = i < end ? live(i) : -1;
    const bool ok = entry >= 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    sync();
    int offset = count, total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      offset += w < warp ? warp_counts[w] : 0;
      total += warp_counts[w];
    }
    if (ok) list[offset + __popc(ballot & ((1u << lane) - 1u))] = entry;
    count += total;
    sync();
  }
  return count;
}

// ------------------------------------------------------------------ host
// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no libcuda link)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// Tensor map of a contiguous bf16 (slices, rows, cols) tensor as the 3-D
// (cols, rows, slices) with 64 x 64 boxes and 128-byte swizzle: a box that
// runs past `rows` or `cols` is zero-filled, never read from the next slice.
inline cudaError_t tile_map(CUtensorMap* map, const void* base, int slices, int rows,
                            int cols) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slices)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of a row-major bf16 (rows, cols) matrix as the 2-D (cols,
// rows) with boxes of 64 columns (one 128-byte line) x `box_rows` rows and
// 128-byte swizzle; cols must be a multiple of 8 (16-byte rows). A box that
// runs past the last row or column is zero-filled.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rows, int cols,
                            int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of a row-major int8 (rows, cols) matrix as the 2-D (cols,
// rows) with boxes of 128 columns (one 128-byte line) x `box_rows` rows and
// 128-byte swizzle; cols * 1 byte must be a multiple of 16. A box that runs
// past the last row or column is zero-filled.
inline cudaError_t int8_map(CUtensorMap* map, const void* base, int rows, int cols,
                            int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
