// The quantized GEMMs' two kernels, shared by K6b (w8a8_gemm.cu: int8 rows
// x int8 codes), K9 (w4a8_gemm.cu: int8 rows x packed int4 codes) and K10
// (w8a16_gemm.cu: bf16 rows x int8 or packed int4 codes). Each source
// instantiates its own formats; the notes at the top of the three sources
// say what bounds each product and which design serves it.
//
// Decode ring (K6b to 16 rows, K9 to 64, K10 to 192 a launch): bound by the
// weight bytes at decode rows.
// - One launch serves up to 3 projections of one input (q/k/v, gate/up; a
//   table of {weight map, scale, bias, out, N} segments). The work units
//   are (64-column tile of a segment, K slice); the plan (split, ring
//   depth, grid) comes from the wrapper (`quant.gemm_decode_plan`).
// - Split launches (to 64 rows): the S K-slices of a column tile form one
//   thread-block cluster. Each block sums its slice and stores its partial
//   rows into rank 0's shared memory (st.async, counted on rank 0's
//   mbarrier); rank 0 adds the S partials in rank order and writes the
//   tile. No atomics, no scratch. Whole-K launches: persistent blocks, each
//   walking every grid-th column tile with its ring running on from one
//   tile to the next; each consumer warp writes its columns from registers.
// - One producer warp streams the tile's 128-byte k-lines of the codes (64
//   rows, 128-byte swizzle, by TMA from a tensor map cached per weight: a
//   line holds 128 int8 codes or 256 int4 ones), the M activation rows of
//   the same k range (bulk copies, no tensor map per call) and, with
//   grouped scales, the scale row of each group that ends in the line
//   (cp.async, zeros past N) into a ring of stages (full / empty
//   mbarriers); columns past the matrix arrive as zeros. Consumer warps
//   (K6b: 4 of 16 columns; K9, K10: 8 of 8 columns at up to 16 rows, two
//   rows of 4 warps of 16 columns over the m-tiles above) widen the codes
//   in registers (int4: two masks put each code, times 16, in a byte; K10:
//   int8 to bf16 by a byte permute under an fp32 exponent and one
//   subtraction; all exact) and run mma.sync from shared memory while the
//   next stages land: m16n8k32 s8 (K6b, K9) or m16n8k16 bf16 (K10). Each
//   lane takes 16 contiguous k of a weight row and of each activation row
//   in a 64-k chunk; the k order inside the chunk is permuted the same way
//   for both operands, which leaves every dot product unchanged.
// - The sums. Integer sums (per-channel K6b and K9) are exact in any
//   order. K6b's grouped terms are folded in fp32 (its own bits, kept).
//   K9's grouped int32 sums and K10's fp32 sums of a scale group are
//   multiplied by the group's scale exactly in fp64 and added there
//   (__fma_rn), K10's per-channel sums a line at a time; a sum of such
//   terms is exact unless they span more than ~2^20 in magnitude, and is
//   rounded to fp32 once. So a row's bits do not depend on M, on the split,
//   on the tile order or on whether a projection shares its launch, and
//   K9's decode ring and prefill tiles give a row the same bits. Groups of
//   128 (two 64-k chunks) are summed each into their own accumulators and
//   folded after the line's products, so no fold waits on them.
//
// Prefill tiles (M > 16 for K6b, M > 64 for K9): bound by int8 operations.
// A block computes a 128 x BN output tile with wgmma m64nBNk32 .s32.s8.s8,
// both operands from shared memory. One producer warp streams the k lines
// of the activations (128 rows) and of the codes (BN rows) by TMA into a
// ring of stages (full / empty mbarriers); two consumer warpgroups each
// own 64 rows of the tile and issue the 4 k-steps of a stage while the
// next stages land. K9's codes arrive packed (64-byte boxes, 128 k); the
// two warpgroups widen each stage to int8 into one of two 128-byte-
// swizzled tiles (a named barrier before, so no product still reads it,
// and one after, with an async-proxy fence), which wgmma then reads as
// K6b's weight tile. K9's grouped tiles are 128 x 64 (the fp64 sums) with
// their scale rows staged like the decode ring's; with groups of 128 (one
// stage) the products of a stage run into one of two accumulator sets
// while the previous stage's group is folded from the other. Blocks run
// along M first, so the blocks that share a weight panel run together and
// read it from device memory once. Rows past M and columns past N arrive
// as zeros and are not stored.
#pragma once

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "hopper.cuh"

namespace qgemm {

// ------------------------------------------------------------------ parts
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
// nibble) -> 16 int8 in k order, 4 a word, each 16 times its code: the
// nibble moved to the byte's high half is its code times 16 with the sign
// in place (two masks, no sign fix). Products of these sum to 16 times the
// true sum exactly (int32: 2^4 x 18,944 x 127 x 7 < 2^31; fp32: a power of
// two), undone by `dc_unscale`.
__device__ __forceinline__ void unpack_int4x16_x16(uint2 w, uint32_t (&b)[4]) {
  const uint32_t m = 0xF0F0F0F0u;
  const uint32_t lo0 = (w.x << 4) & m, hi0 = w.x & m, lo1 = (w.y << 4) & m, hi1 = w.y & m;
  b[0] = __byte_perm(lo0, hi0, 0x5140);
  b[1] = __byte_perm(lo0, hi0, 0x7362);
  b[2] = __byte_perm(lo1, hi1, 0x5140);
  b[3] = __byte_perm(lo1, hi1, 0x7362);
}

// the four signed int8 codes of w as two bf16 pairs (bytes 0, 1 in lo; 2,
// 3 in hi), exactly and without conversion instructions: byte b + 128,
// permuted under the exponent 0x4B, is the fp32 2^23 + b + 128, so one
// subtraction gives b; a small integer's bf16 is its fp32's high half
__device__ __forceinline__ void s8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// an int32 as a double, exactly, without a conversion instruction: its
// bits + 2^31 as the low word of 2^52 + x, minus 2^52 + 2^31
__device__ __forceinline__ double to_double(int v) {
  return __hiloint2double(0x43300000, static_cast<int>(static_cast<uint32_t>(v) ^ 0x80000000u)) -
         4503601774854144.0;
}
__device__ __forceinline__ double to_double(float v) { return static_cast<double>(v); }

// 4 bytes from global memory into shared memory, asynchronously: `bytes`
// (4 or 0) are read, the rest filled with zeros
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// the mbarrier's current phase also waits for this thread's earlier cp.async
// copies (its pending count is raised now and lowered when they land)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(hopper::smem_u32(bar))
               : "memory");
}

// two outputs of row m at columns n, n + 1 (the second only if n + 1 < N),
// as a bf16 pair where the pair's address is 4-byte aligned ((m N + n)
// even), else one at a time: odd N works
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

// store two fp64 words into a cluster block's shared memory and count
// their 16 bytes on its mbarrier (addresses from hopper::cluster_addr)
__device__ __forceinline__ void st_async_f64x2(uint32_t addr, double x, double y, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "d"(x), "d"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// ------------------------------------------------------------------ decode
constexpr int DC_BN = 64;         // weight rows (output columns) of a tile
constexpr int DC_LINE = 128;      // weight bytes of a stage's row: one 128-byte line
constexpr int DC_MAX_M = 16;      // rows of the 4-warp tiles
constexpr int DC_MAX_M_WIDE = 192;  // rows of K10's ring
constexpr int DC_MAX_M_K9 = 64;      // rows of K9's ring (above: the prefill tiles)
constexpr int DC_MAX_M_SPLIT = 64;   // rows a split launch takes
constexpr int DC_WARP_COLS = 8;   // columns of an n8 tile; a consumer warp takes J of them
constexpr int DC_MAX_STAGES = 6;
constexpr int DC_MAX_SEGMENTS = 3;
constexpr int DC_MAX_CLUSTER = 8;  // the portable cluster size
constexpr int DC_W_BYTES = DC_BN * DC_LINE;  // 8 KB, 1024-byte aligned (swizzle atoms)
constexpr int SMEM_OPTIN = 232448;           // shared memory a block may take on sm_90

// The operand formats of a decode launch: the code width (8, or 4 packed
// two a byte), the activation bytes a k (1: int8, 2: bf16) and whether the
// sums that span units are added in fp64.
template <int WBITS, int ABYTES, bool FP64>
struct Format {
  static constexpr int kWBits = WBITS;
  static constexpr int kABytes = ABYTES;
  static constexpr bool kFp64 = FP64;
  static constexpr int kLineK = DC_LINE * 8 / WBITS;  // k of one weight line: 128 or 256
  static constexpr int kChunks = kLineK / 64;         // 64-k chunks of a line
  static constexpr int kAStride = kLineK * ABYTES + 16;  // bytes an activation row: conflict-free
  using Acc = typename std::conditional<ABYTES == 2, float, int>::type;
};
using W8A8 = Format<8, 1, false>;  // K6b
using W4A8 = Format<4, 1, true>;   // K9
template <int WBITS>
using W16 = Format<WBITS, 2, true>;  // K10

// What a launch folds: fp64 (K9 grouped, K10), K6b's fp32 group fold, or
// nothing (an exact int32 sum a column)
template <class F, bool GROUPED>
struct Fold {
  static constexpr bool kF64 = F::kFp64 && (GROUPED || F::kABytes == 2);
  static constexpr bool kF32 = !F::kFp64 && GROUPED;
  using T = typename std::conditional<kF64, double, float>::type;
  static constexpr int kRedBytes = kF64 ? 8 : 4;  // a partial word of a split launch
};

// activation rows a stage holds: K6b 16, or M rounded up to 16 above;
// K9 and K10 M rounded up to 8
template <class F>
__host__ __device__ constexpr int dc_a_rows(int M) {
  return F::kFp64 ? (M + 7) / 8 * 8 : M <= DC_MAX_M ? DC_MAX_M : (M + 15) / 16 * 16;
}

// a stage's bytes after its weight line: the activation rows, then with
// grouped scales one 64-column scale row for each 64-k chunk of the line
// (filled where a scale group ends in that chunk)
template <class F>
__host__ __device__ constexpr int dc_a_bytes(int M, bool grouped) {
  return dc_a_rows<F>(M) * F::kAStride + (grouped ? F::kChunks * DC_BN * 4 : 0);
}

// shared memory of a block: the ring, rank 0's partials (S x M x 64 words,
// split launches only) and the barriers
template <class F>
constexpr size_t dc_smem_bytes(int stages, int split, int M, bool grouped, int red_bytes) {
  return 1024 + static_cast<size_t>(stages) * (DC_W_BYTES + dc_a_bytes<F>(M, grouped)) +
         (split > 1 ? static_cast<size_t>(split) * M * DC_BN * red_bytes : 0) +
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
  const void* x;         // (M, K) int8 or bf16
  const float* a_scale;  // (M,) for int8 rows, else null
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
// segment sg: 64 weight rows by TMA, the M activation rows by bulk copies,
// and with grouped scales the scale row of each group that ends in the line
// (cp.async, 4 bytes a column, zeros past N; counted on the same barrier,
// every lane's before lane 0's arrival can complete the phase)
template <class F, bool GROUPED>
__device__ __forceinline__ void dc_load(const DecodeParams& p, int sg, int n0, int l,
                                        unsigned char* w, unsigned char* a, uint64_t* full,
                                        int lane) {
  const int k = l * F::kLineK;
  const int abytes = min(F::kLineK, p.K - k) * F::kABytes;
  if constexpr (GROUPED) {
    float* slots = reinterpret_cast<float*>(a + dc_a_rows<F>(p.M) * F::kAStride);
    const int per_group = p.group / 64, chunk0 = l * F::kChunks;
    const int chunks = min(F::kChunks, (p.K - k) / 64);
    const int N = p.seg[sg].N;
    for (int h = 0; h < chunks; ++h) {
      if ((chunk0 + h + 1) % per_group == 0) {
        const float* row = p.seg[sg].scale + static_cast<size_t>((chunk0 + h) / per_group) * N;
#pragma unroll
        for (int c = lane; c < DC_BN; c += 32) {
          const bool in = n0 + c < N;
          cp_async_4(slots + h * DC_BN + c, row + (in ? n0 + c : 0), in ? 4 : 0);
        }
      }
    }
    cp_async_arrive(full);
  }
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive_expect_tx(full, DC_W_BYTES + p.M * abytes);
  __syncwarp();
  if (lane == 0) hopper::tma_load_2d(w, &p.w[sg], full, l * DC_LINE, n0);
  const unsigned char* x = static_cast<const unsigned char*>(p.x);
  for (int r = lane; r < p.M; r += 32) {
    hopper::bulk_load(a + r * F::kAStride,
                      x + (static_cast<size_t>(r) * p.K + k) * F::kABytes, abytes, full);
  }
}

// a sum of int4 codes' products taken 16 times over (`unpack_int4x16_x16`)
// brought back, exactly; 8-bit codes' sums as they are
template <class F>
__device__ __forceinline__ int dc_unscale(int v) {
  return F::kWBits == 4 ? v >> 4 : v;
}
template <class F>
__device__ __forceinline__ float dc_unscale(float v) {
  return F::kWBits == 4 ? v * 0.0625f : v;
}

// A consumer warp's products of k-line `l` (its 8 J columns, group nw of
// the stage's 64, over m-tiles mt0 .. mt0 + MT - 1), and the folds of the
// scale groups that end in it: acc[mt][j][e] is row 16 (mt0 + mt) + g + 8
// (e / 2), column 8 J nw + 8 j + 2 t + e % 2. With GPC > 0 (the 64-k
// chunks of a scale group, dividing a line's) each group of the line sums
// into its own accumulators and the groups are folded in order after the
// line's products, so no fold waits on the products that follow it;
// GPC = 0 folds each group as it ends (any group width), into `acc`. An
// output's arithmetic depends on none of J, MT or GPC.
template <class F, bool GROUPED, int MT, int J, int GPC>
__device__ __forceinline__ void dc_products(typename F::Acc (&acc)[MT][J][4],
                                            typename Fold<F, GROUPED>::T (&fold)[MT][J][4],
                                            const unsigned char* a, const unsigned char* w,
                                            int l, int K, int M, int mt0, int nw, int group) {
  using Fd = Fold<F, GROUPED>;
  using Acc = typename F::Acc;
  constexpr bool kSlots = GROUPED && GPC > 0;
  constexpr int S = kSlots ? F::kChunks / GPC : 1;
  static_assert(!kSlots || F::kChunks % GPC == 0, "a group within a line");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int chunk0 = l * F::kChunks;  // 64-k chunks before this line
  const int chunks = min(F::kChunks, (K - l * F::kLineK) / 64);
  // the scale rows the producer staged for the groups that end in this line
  const float* scales = reinterpret_cast<const float*>(a + dc_a_rows<F>(M) * F::kAStride) +
                        nw * DC_WARP_COLS * J + 2 * t;
  w += nw * DC_WARP_COLS * J * DC_LINE;

  // fold group sums c (one group, ending in chunk h) with their scale row
  auto fold_group = [&](Acc(&c)[MT][J][4], int h) {
    const float* sc = scales + h * DC_BN;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float s0 = sc[8 * j], s1 = sc[8 * j + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (Fd::kF32) {  // K6b's fold
            fold[mt][j][e] += static_cast<float>(c[mt][j][e]) * ((e & 1) ? s1 : s0);
          } else {  // the exact product acc_g * scale, added in fp64
            fold[mt][j][e] = __fma_rn(to_double(dc_unscale<F>(c[mt][j][e])),
                                      static_cast<double>((e & 1) ? s1 : s0), fold[mt][j][e]);
          }
          c[mt][j][e] = 0;
        }
    }
  };

  Acc slot[S][MT][J][4];
  if constexpr (kSlots) {
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) slot[i][mt][j][e] = 0;
  }

  // the products of chunk h into c
  auto products = [&](Acc(&c)[MT][J][4], int h) {
    // this lane's 16 codes of weight rows 8 j + g, as int8, 4 a word; in
    // the swizzle, 16-byte unit u of row r sits at unit u ^ (r % 8), and
    // r % 8 == g
    uint32_t b[J][4];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const unsigned char* row = w + (8 * j + g) * DC_LINE;
      if constexpr (F::kWBits == 8) {
        const int4 v = *reinterpret_cast<const int4*>(row + 16 * ((4 * h + t) ^ g));
        b[j][0] = v.x, b[j][1] = v.y, b[j][2] = v.z, b[j][3] = v.w;
      } else {
        const int off = 32 * h + 8 * t;
        unpack_int4x16_x16(
            *reinterpret_cast<const uint2*>(row + 16 * ((off >> 4) ^ g) + (off & 15)), b[j]);
      }
    }
    if constexpr (F::kABytes == 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m0 = 16 * (mt0 + mt);
        if (m0 < M) {  // warp-uniform
          const int cb = 4 * h + t;  // this lane's 16 bytes of the row's 128-byte line
          const int4 zero = make_int4(0, 0, 0, 0);
          const int4 lo = m0 + g < M
                              ? *reinterpret_cast<const int4*>(a + (m0 + g) * F::kAStride + 16 * cb)
                              : zero;
          const int4 hi = m0 + g + 8 < M ? *reinterpret_cast<const int4*>(
                                               a + (m0 + g + 8) * F::kAStride + 16 * cb)
                                         : zero;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            mma_s8(c[mt][j], lo.x, hi.x, lo.y, hi.y, b[j][0], b[j][1]);
            mma_s8(c[mt][j], lo.z, hi.z, lo.w, hi.w, b[j][2], b[j][3]);
          }
        }
      }
    } else {
      uint32_t bb[J][4][2];  // the codes as bf16 pairs, shared by the m-tiles
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) s8x4_to_bf16x4(b[j][q], bb[j][q][0], bb[j][q][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m0 = 16 * (mt0 + mt);
        if (m0 < M) {  // warp-uniform
          const int off = 2 * (64 * h + 16 * t);  // this lane's 32 bytes of the row
          uint32_t a0[8], a1[8];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = m0 + g + 8 * hh;
            uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
            if (r < M) {
              v0 = *reinterpret_cast<const uint4*>(a + r * F::kAStride + off);
              v1 = *reinterpret_cast<const uint4*>(a + r * F::kAStride + off + 16);
            }
            uint32_t* d = hh ? a1 : a0;
            d[0] = v0.x, d[1] = v0.y, d[2] = v0.z, d[3] = v0.w;
            d[4] = v1.x, d[5] = v1.y, d[6] = v1.z, d[7] = v1.w;
          }
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              mma_bf16(c[mt][j], a0[2 * q], a1[2 * q], a0[2 * q + 1], a1[2 * q + 1],
                       bb[j][q][0], bb[j][q][1]);
            }
        }
      }
    }
  };

#pragma unroll
  for (int h = 0; h < F::kChunks; ++h) {
    if (h < chunks) {
      if constexpr (kSlots) {
        products(slot[h / GPC], h);
      } else {
        products(acc, h);
        if constexpr (GROUPED) {
          if ((chunk0 + h + 1) % (group / 64) == 0) fold_group(acc, h);  // a group ends
        } else if constexpr (Fd::kF64) {  // K10 per channel: each line's fp32 sum
          if (h == chunks - 1) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int j = 0; j < J; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  fold[mt][j][e] = __dadd_rn(fold[mt][j][e],
                                             static_cast<double>(dc_unscale<F>(acc[mt][j][e])));
                  acc[mt][j][e] = 0;
                }
          }
        }
      }
    }
  }
  if constexpr (kSlots) {  // the line's groups, in order (K % group == 0: all whole)
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if ((i + 1) * GPC <= chunks) fold_group(slot[i], (i + 1) * GPC - 1);
    }
  }
}

// The output of one column from its sum: `v` the exact int32 sum (no
// fold), else the folded sum rounded to fp32; `as` the row's activation
// scale (int8 rows), `sc` the column's per-channel scale. The JAX order:
// per channel (float(acc) * as) * sc, grouped (sum of terms) * as; K10 has
// no activation scale. Then + bias, every step rounded on its own.
template <class F, bool GROUPED>
__device__ __forceinline__ float dc_out(float v, float as, float sc, bool has_bias, float bias) {
  float y;
  if constexpr (F::kABytes == 2) {
    y = GROUPED ? v : __fmul_rn(v, sc);
  } else {
    y = GROUPED ? __fmul_rn(v, as) : __fmul_rn(__fmul_rn(v, as), sc);
  }
  return has_bias ? __fadd_rn(y, bias) : y;
}

// a block's threads: MW rows of consumer warps of 8 J columns, and the
// producer warp
template <int MW, int J>
constexpr int dc_threads() {
  return 32 * (DC_BN / (DC_WARP_COLS * J) * MW + 1);
}

// The blocks an SM must hold of a layout: K9's and K10's two rows of warps
// of two m-tiles each (17 to 64 rows) are launched as `*_kernel_2`, whose
// launch bounds ask for two blocks an SM (at most 113 registers a thread;
// at the 122-132 they took unbounded, one block's 8 consumer warps
// could not keep the SM busy); the planner counts on it
// (`quant.DecodeGeometry.mid_blocks`, with rings of 2 stages there). The
// other layouts name no minimum: naming 1 made ptxas give the up-to-16-row
// layout more registers, fewer blocks an SM and a slower decode.
template <class F, int MW, int MT>
constexpr int dc_min_blocks() {
  return F::kFp64 && MW == 2 && MT == 2 ? 2 : 1;
}

// Split launches (p.split > 1, M <= 64): one column tile a cluster of
// p.split blocks, block `rank` summing K slice `rank`; the partial rows go
// to rank 0, which adds them in rank order and writes the tile. MW rows of
// warps, each warp MT m-tiles and 8 J columns.
template <class F, bool GROUPED, int MW, int MT, int J, int GPC>
__device__ __forceinline__ void decode_split_body(const DecodeParams& p) {
  using namespace hopper;
  using Fd = Fold<F, GROUPED>;
  using Red = typename std::conditional<Fd::kF64, double, uint32_t>::type;
  constexpr int kRow = DC_BN / (DC_WARP_COLS * J);  // warps of a row of warps
  constexpr int kConsumers = kRow * MW;
  constexpr int kThreads = 32 * (kConsumers + 1);
  constexpr int kMaxRows = 16 * MW * MT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int stages = p.stages, S = p.split, M = p.M, K = p.K;
  const int a_bytes = dc_a_bytes<F>(M, GROUPED);
  unsigned char* wring = smem;
  unsigned char* aring = smem + stages * DC_W_BYTES;
  Red* red = reinterpret_cast<Red*>(aring + stages * a_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + S * M * DC_BN);
  uint64_t* empty = full + DC_MAX_STAGES;
  uint64_t* red_full = empty + DC_MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(blockIdx.x % S);  // the rank in the cluster
  int sg, n0, N;
  dc_segment(p, blockIdx.x / S, sg, n0, N);

  // this block's lines: split units dealt evenly over the cluster
  const int lines = (K + F::kLineK - 1) / F::kLineK;
  const int units = (lines + p.unit_lines - 1) / p.unit_lines;
  const int l0 = min(lines, rank * units / S * p.unit_lines);
  const int l1 = min(lines, (rank + 1) * units / S * p.unit_lines);
  const int nl = l1 - l0;

  if (warp == 0) {  // one barrier a lane
    if (lane < stages) {
      mbar_init(&full[lane], 1);
      mbar_init(&empty[lane], kConsumers);
    } else if (lane == DC_MAX_STAGES) {
      mbar_init(red_full, 1);
      // rank 0 receives every block's partial rows: S x M x 64 words
      if (rank == 0) mbar_arrive_expect_tx(red_full, S * M * DC_BN * sizeof(Red));
    }
    fence_barrier_init();
  }
  __syncthreads();
  cluster_arrive_relaxed();  // rank 0's barrier is ready; waited for before the partials go

  if (warp == kConsumers) {
    // ------------------------------------------------------------ producer
    for (int i = 0; i < nl; ++i) {
      const int s = i % stages;
      if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
      dc_load<F, GROUPED>(p, sg, n0, l0 + i, wring + s * DC_W_BYTES, aring + s * a_bytes,
                          &full[s], lane);
    }
    cluster_wait();
  } else {
    // ---------------------------------------------------------- consumers
    const int nw = warp % kRow, mt0 = (warp / kRow) * MT;
    typename F::Acc acc[MT][J][4] = {};
    typename Fd::T fold[MT][J][4] = {};
    for (int i = 0; i < nl; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      dc_products<F, GROUPED, MT, J, GPC>(acc, fold, aring + s * a_bytes, wring + s * DC_W_BYTES,
                                          l0 + i, K, M, mt0, nw, p.group);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // this block's partial rows (< M) into rank 0's shared memory
    cluster_wait();
    const int g = lane >> 2, t = lane & 3;
    const uint32_t bar = cluster_addr(red_full, 0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * (mt0 + mt) + g + 8 * hh;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int col = nw * DC_WARP_COLS * J + 8 * j + 2 * t;
          const uint32_t dst = cluster_addr(red + (rank * M + row) * DC_BN + col, 0);
          if constexpr (Fd::kF64) {
            st_async_f64x2(dst, fold[mt][j][2 * hh], fold[mt][j][2 * hh + 1], bar);
          } else {
            const uint32_t x = GROUPED ? __float_as_uint(fold[mt][j][2 * hh])
                                       : static_cast<uint32_t>(dc_unscale<F>(acc[mt][j][2 * hh]));
            const uint32_t y =
                GROUPED ? __float_as_uint(fold[mt][j][2 * hh + 1])
                        : static_cast<uint32_t>(dc_unscale<F>(acc[mt][j][2 * hh + 1]));
            st_async_v2(dst, x, y, bar);
          }
        }
      }
  }
  if (rank != 0) return;

  // rank 0: the tile's outputs in column pairs over the block's threads,
  // each the sum of the S partials in rank order; the epilogue's operands
  // are loaded while the partials arrive
  const DecodeSegment& seg = p.seg[sg];
  constexpr int kPairs = DC_BN / 2;
  constexpr int kMaxPerThread = (kMaxRows * kPairs + kThreads - 1) / kThreads;
  float as[kMaxPerThread], sc[kMaxPerThread][2], bi[kMaxPerThread][2];
#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) {
    const int q = tid + u * kThreads;
    const int m = min(q / kPairs, M - 1), n = n0 + 2 * (q % kPairs);
    as[u] = p.a_scale != nullptr ? p.a_scale[m] : 1.f;
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
    const int q = tid + u * kThreads;
    const int m = q / kPairs, c = 2 * (q % kPairs);
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    float v[2];
    if constexpr (Fd::kF64) {
      double sum[2] = {0.0, 0.0};
      for (int r = 0; r < S; ++r) {
        const double* pr = red + (r * M + m) * DC_BN + c;
        sum[0] = __dadd_rn(sum[0], pr[0]);
        sum[1] = __dadd_rn(sum[1], pr[1]);
      }
      v[0] = __double2float_rn(sum[0]);
      v[1] = __double2float_rn(sum[1]);
    } else if constexpr (GROUPED) {
      float sum[2] = {0.f, 0.f};
      for (int r = 0; r < S; ++r) {
        const uint2 x = *reinterpret_cast<const uint2*>(red + (r * M + m) * DC_BN + c);
        sum[0] += __uint_as_float(x.x);
        sum[1] += __uint_as_float(x.y);
      }
      v[0] = sum[0], v[1] = sum[1];
    } else {
      int sum[2] = {0, 0};
      for (int r = 0; r < S; ++r) {
        const uint2 x = *reinterpret_cast<const uint2*>(red + (r * M + m) * DC_BN + c);
        sum[0] += static_cast<int>(x.x);
        sum[1] += static_cast<int>(x.y);
      }
      v[0] = __int2float_rn(sum[0]), v[1] = __int2float_rn(sum[1]);
    }
    const bool has_bias = seg.bias != nullptr;
    store_pair(seg.out, m, n, N, dc_out<F, GROUPED>(v[0], as[u], sc[u][0], has_bias, bi[u][0]),
               dc_out<F, GROUPED>(v[1], as[u], sc[u][1], has_bias, bi[u][1]));
  }
}

// Whole-K launches (p.split == 1): persistent blocks, block b walking the
// column tiles b, b + gridDim.x, ... (in `dc_segment`'s order); the ring
// runs on from one tile to the next, and each consumer warp writes its
// columns from registers. MW rows of 4 warps, each warp MT m-tiles.
template <class F, bool GROUPED, int MW, int MT, int J, int GPC>
__device__ __forceinline__ void decode_stream_body(const DecodeParams& p) {
  using namespace hopper;
  using Fd = Fold<F, GROUPED>;
  constexpr int kRow = DC_BN / (DC_WARP_COLS * J);  // warps of a row of warps
  constexpr int kConsumers = kRow * MW;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int stages = p.stages, M = p.M, K = p.K;
  const int a_bytes = dc_a_bytes<F>(M, GROUPED);
  unsigned char* wring = smem;
  unsigned char* aring = smem + stages * DC_W_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(aring + stages * a_bytes);
  uint64_t* empty = full + DC_MAX_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lines = (K + F::kLineK - 1) / F::kLineK;

  if (warp == 0) {
    if (lane < stages) {
      mbar_init(&full[lane], 1);
      mbar_init(&empty[lane], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ------------------------------------------------------------ producer
    int i = 0;  // lines through the ring
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      int sg, n0, N;
      dc_segment(p, tile, sg, n0, N);
      for (int l = 0; l < lines; ++l, ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
        dc_load<F, GROUPED>(p, sg, n0, l, wring + s * DC_W_BYTES, aring + s * a_bytes, &full[s],
                            lane);
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  const int g = lane >> 2, t = lane & 3;
  const int nw = warp % kRow, mt0 = (warp / kRow) * MT;
  float as[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = min(16 * (mt0 + mt) + g + 8 * hh, M - 1);
      as[mt][hh] = p.a_scale != nullptr ? p.a_scale[m] : 1.f;
    }
  int i = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int sg, n0, N;
    dc_segment(p, tile, sg, n0, N);
    const DecodeSegment& seg = p.seg[sg];
    // the epilogue's operands of this warp's columns, loaded ahead
    float sc[J][2], bi[J][2];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ne = min(n0 + nw * DC_WARP_COLS * J + 8 * j + 2 * t + e, N - 1);
        sc[j][e] = GROUPED ? 0.f : seg.scale[ne];
        bi[j][e] = seg.bias != nullptr ? seg.bias[ne] : 0.f;
      }
    typename F::Acc acc[MT][J][4] = {};
    typename Fd::T fold[MT][J][4] = {};
    for (int l = 0; l < lines; ++l, ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      dc_products<F, GROUPED, MT, J, GPC>(acc, fold, aring + s * a_bytes, wring + s * DC_W_BYTES,
                                          l, K, M, mt0, nw, p.group);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 16 * (mt0 + mt) + g + 8 * hh;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int n = n0 + nw * DC_WARP_COLS * J + 8 * j + 2 * t;
          if (n >= N) continue;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 2 * hh + e;
            const float v = Fd::kF64   ? __double2float_rn(fold[mt][j][x])
                            : GROUPED ? static_cast<float>(fold[mt][j][x])
                                      : to_float(dc_unscale<F>(acc[mt][j][x]));
            y[e] = dc_out<F, GROUPED>(v, as[mt][hh], sc[j][e], seg.bias != nullptr, bi[j][e]);
          }
          store_pair(seg.out, m, n, N, y[0], y[1]);
        }
      }
  }
}

// The kernels over the two bodies (`dc_min_blocks`)
template <class F, bool GROUPED, int MW, int MT, int J, int GPC>
__global__ void __launch_bounds__(dc_threads<MW, J>())
    decode_split_kernel(const __grid_constant__ DecodeParams p) {
  decode_split_body<F, GROUPED, MW, MT, J, GPC>(p);
}
template <class F, bool GROUPED, int MW, int MT, int J, int GPC>
__global__ void __launch_bounds__(dc_threads<MW, J>(), 2)
    decode_split_kernel_2(const __grid_constant__ DecodeParams p) {
  decode_split_body<F, GROUPED, MW, MT, J, GPC>(p);
}
template <class F, bool GROUPED, int MW, int MT, int J, int GPC>
__global__ void __launch_bounds__(dc_threads<MW, J>())
    decode_stream_kernel(const __grid_constant__ DecodeParams p) {
  decode_stream_body<F, GROUPED, MW, MT, J, GPC>(p);
}
template <class F, bool GROUPED, int MW, int MT, int J, int GPC>
__global__ void __launch_bounds__(dc_threads<MW, J>(), 2)
    decode_stream_kernel_2(const __grid_constant__ DecodeParams p) {
  decode_stream_body<F, GROUPED, MW, MT, J, GPC>(p);
}

// the tensor map of a weight (N rows of row_bytes) in 64-row boxes of
// 128-byte lines, built once per (pointer, N, row_bytes): weights live as
// long as their module
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int N, int row_bytes) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(w, N, row_bytes);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const cudaError_t err = hopper::int8_map(map, w, N, row_bytes, DC_BN);
  if (err == cudaSuccess) {
    if (cache.size() >= 4096) cache.clear();  // freed weights' entries
    cache.emplace(key, *map);
  }
  return err;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
  configured = err == cudaSuccess;
  return err;
}

// one decode launch of `kernel` under cfg, its shared memory allowed first
template <class Kernel>
cudaError_t launch_ex(Kernel kernel, const cudaLaunchConfig_t& cfg, const DecodeParams& p,
                      bool& configured) {
  cudaError_t err = allow_smem(kernel, configured);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class F, bool GROUPED, int MW, int MT, int J, int GPC>
cudaError_t launch_decode(const DecodeParams& p, int blocks, cudaStream_t stream) {
  static bool configured[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const bool split = p.split > 1;
  const size_t smem =
      dc_smem_bytes<F>(p.stages, p.split, p.M, GROUPED, Fold<F, GROUPED>::kRedBytes);
  if (smem > SMEM_OPTIN || (split && MW * MT > 4)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(dc_threads<MW, J>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split ? 1 : 0;
  constexpr bool kTwo = dc_min_blocks<F, MW, MT>() == 2;
  if constexpr (MW * MT <= 4) {  // splits up to 64 rows
    if (split) {
      if constexpr (kTwo) {
        return launch_ex(decode_split_kernel_2<F, GROUPED, MW, MT, J, GPC>, cfg, p,
                         configured[dev][1]);
      } else {
        return launch_ex(decode_split_kernel<F, GROUPED, MW, MT, J, GPC>, cfg, p,
                         configured[dev][1]);
      }
    }
  }
  if constexpr (kTwo) {
    return launch_ex(decode_stream_kernel_2<F, GROUPED, MW, MT, J, GPC>, cfg, p,
                     configured[dev][0]);
  } else {
    return launch_ex(decode_stream_kernel<F, GROUPED, MW, MT, J, GPC>, cfg, p,
                     configured[dev][0]);
  }
}

template <class F, bool GROUPED, int GPC>
cudaError_t launch_decode_rows(const DecodeParams& p, int blocks, cudaStream_t s) {
  // K6b: 4 warps of 16 columns; K9 and K10: 8 warps of 8 (the consumers'
  // products, not the bytes, set their pace)
  constexpr int J = F::kFp64 ? 1 : 2;
  if (p.M <= DC_MAX_M) return launch_decode<F, GROUPED, 1, 1, J, GPC>(p, blocks, s);
  if constexpr (F::kFp64) {
    // above 16 rows (K9 to 64, K10 to 192): 2 rows of 4 warps of 16
    // columns, each warp MT m-tiles
    if (p.M <= 64) return launch_decode<F, GROUPED, 2, 2, 2, GPC>(p, blocks, s);
    if constexpr (F::kABytes == 2) {
      if (p.M <= 96) return launch_decode<F, GROUPED, 2, 3, 2, GPC>(p, blocks, s);
      return launch_decode<F, GROUPED, 2, 6, 2, GPC>(p, blocks, s);
    }
  }
  return cudaErrorInvalidValue;
}

// A decode launch of format F: x (M, K) int8 or bf16, a_scale (M,) fp32 or
// null, up to 3 segments (projections of the same input), segment i with
// codes wi (Ni rows of K * bits / 8 bytes), scale si (Ni,) or (K / group,
// Ni) fp32, bias bi (Ni,) fp32 or null, out oi (M, Ni) bf16; segments past
// nseg are ignored. The plan (`quant.gemm_decode_plan`): block_n (must be
// 64), split (the K slices of a column tile and the cluster size, 1-8;
// only 1 above 16 rows), unit_lines (the weight lines of a split unit),
// stages (ring depth, 1-6), blocks (the grid: column tiles x split, or
// with split 1 at most the tiles, each block walking every blocks-th
// tile). Returns a cudaError_t.
template <class F>
int decode_entry(const void* x, const void* a_scale, int M, int K, int group, int nseg,
                 int block_n, int split, int unit_lines, int stages, int blocks,
                 const void* const (&w)[DC_MAX_SEGMENTS], const void* const (&sc)[DC_MAX_SEGMENTS],
                 const void* const (&b)[DC_MAX_SEGMENTS], void* const (&o)[DC_MAX_SEGMENTS],
                 const int (&n)[DC_MAX_SEGMENTS], void* stream) {
  const int max_m = F::kABytes == 2 ? DC_MAX_M_WIDE : F::kFp64 ? DC_MAX_M_K9 : DC_MAX_M;
  if (M < 1 || M > max_m || nseg < 1 || nseg > DC_MAX_SEGMENTS || block_n != DC_BN ||
      split < 1 || split > DC_MAX_CLUSTER || (split > 1 && M > DC_MAX_M_SPLIT) || unit_lines < 1 ||
      stages < 1 || stages > DC_MAX_STAGES || K % 64 != 0 || group % 64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DecodeParams p;
  int full = 0;
  for (int i = 0; i < DC_MAX_SEGMENTS; ++i) {
    if (i < nseg) {
      if (n[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
      const cudaError_t err = weight_map(&p.w[i], w[i], n[i], K / 8 * F::kWBits);
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
  p.x = x;
  p.a_scale = static_cast<const float*>(a_scale);
  p.M = M, p.K = K, p.group = group, p.tiles = tiles;
  p.split = split, p.unit_lines = unit_lines, p.stages = stages;
  const auto s = static_cast<cudaStream_t>(stream);
  // grouped-128 scales (the int4 format's and the 8-bit grouped lm_head's)
  // fold each line's groups after its products; other widths as they end
  if (!group) return static_cast<int>(launch_decode_rows<F, false, 0>(p, blocks, s));
  if (group == 128) return static_cast<int>(launch_decode_rows<F, true, 2>(p, blocks, s));
  return static_cast<int>(launch_decode_rows<F, true, 0>(p, blocks, s));
}

// ------------------------------------------------------------------ prefill
constexpr int PF_BM = 128;             // rows of a tile: two consumer warpgroups of 64
constexpr int PF_BK = 128;             // k values (bytes) of a stage: one 128-byte line
constexpr int PF_THREADS = 3 * 128;    // two consumer warpgroups and a producer warpgroup
constexpr int PF_PRODUCER_REGS = 40;
constexpr int PF_CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65,536

template <int WBITS, int BN>
__host__ __device__ constexpr int pf_stages() {
  return WBITS == 8 && BN == 256 ? 4 : WBITS == 4 && BN == 64 ? 6 : 5;
}

// a stage: the activation tile (128 rows of a 128-byte line) and the
// weight tile (BN rows: a 128-byte line of int8 codes, or 64 bytes of
// packed int4 ones)
template <int WBITS, int BN>
__host__ __device__ constexpr int pf_stage_bytes() {
  return PF_BM * PF_BK + BN * PF_BK * WBITS / 8;
}

// K9's grouped tiles stage two scale rows a stage (a group may end after
// each 64-k half), BN floats each
template <int BN>
__host__ __device__ constexpr int pf_scale_bytes() {
  return 2 * BN * 4;
}

// the ring, K9's two widened int8 tiles and grouped scale rows, the barriers
template <int WBITS, int BN, bool GROUPED>
constexpr size_t pf_smem_bytes() {
  return 1024 + static_cast<size_t>(pf_stages<WBITS, BN>()) * pf_stage_bytes<WBITS, BN>() +
         (WBITS == 4 ? 2 * BN * PF_BK : 0) +
         (WBITS == 4 && GROUPED ? pf_stages<WBITS, BN>() * pf_scale_bytes<BN>() : 0) +
         2 * pf_stages<WBITS, BN>() * sizeof(uint64_t);
}

#define QGEMM_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define QGEMM_R32(o)                                                                      \
  QGEMM_R4(o + 0), QGEMM_R4(o + 4), QGEMM_R4(o + 8), QGEMM_R4(o + 12), QGEMM_R4(o + 16), \
      QGEMM_R4(o + 20), QGEMM_R4(o + 24), QGEMM_R4(o + 28)

// d (64 x 64 s32) (+)= A (64 x 32 s8, smem, K-major) * B (32 x 64 s8, smem, K-major)
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : QGEMM_R32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef QGEMM_R32
#undef QGEMM_R4

template <int BN>
__device__ __forceinline__ void pf_wgmma(int (&d)[BN / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (BN == 256) {
    hopper::wgmma_m64n256k32_s8(d, a, b, accumulate);
  } else if constexpr (BN == 128) {
    hopper::wgmma_m64n128k32_s8(d, a, b, accumulate);
  } else {
    wgmma_m64n64k32_s8(d, a, b, accumulate);
  }
}

// the two consumer warpgroups meet (named barrier 1; the producer is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// this thread's shared-memory writes become visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K9: the 256 consumer threads widen the stage's BN x 64-byte int4 tile
// (dense rows, no swizzle) into the BN x 128-byte int8 tile `dst`,
// 128-byte swizzled as TMA would have landed it (16-byte unit u of row r at
// unit u ^ (r % 8)); thread `tid` takes BN / 2 packed bytes of one row
template <int BN>
__device__ __forceinline__ void pf_widen(const unsigned char* src, unsigned char* dst, int tid) {
  constexpr int kParts = 256 / BN;        // threads a row
  constexpr int kBytes = 64 / kParts;     // packed bytes a thread: 32 or 16
  const int row = tid / kParts, part = tid % kParts;
#pragma unroll
  for (int v = 0; v < kBytes / 16; ++v) {
    const uint4 x = *reinterpret_cast<const uint4*>(src + row * 64 + kBytes * part + 16 * v);
    const uint2 packed[2] = {make_uint2(x.x, x.y), make_uint2(x.z, x.w)};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t q[4];
      unpack_int4x16_x16(packed[u], q);
      const int unit = (2 * kBytes * part) / 16 + 2 * v + u;  // 16 int8 codes a unit
      *reinterpret_cast<uint4*>(dst + row * PF_BK + 16 * (unit ^ (row & 7))) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
}

// PIPE (K9, a scale group of one 128-k stage): the products of stage i run
// into one of two accumulator sets while stage i - 1's group is folded from
// the other, so no fold waits for the tensor cores to drain.
template <int WBITS, int BN, bool GROUPED, bool PIPE = false>
__global__ void __launch_bounds__(PF_THREADS, 1)
    prefill_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const float* __restrict__ a_scale, const float* __restrict__ scale,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int N,
                   int K, int group) {
  using namespace hopper;
  constexpr int STAGES = pf_stages<WBITS, BN>();
  constexpr int A_BYTES = PF_BM * PF_BK, STAGE_BYTES = pf_stage_bytes<WBITS, BN>();
  constexpr int NACC = BN / 2;  // s32 accumulators a thread holds for its m64nBN product
  // K9's group terms: the exact products acc_g * scale in fp64, their scale
  // rows staged with the stage (K6b folds in fp32 from device memory)
  constexpr bool F64 = WBITS == 4 && GROUPED;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* wide = smem + STAGES * STAGE_BYTES;  // K9: two widened BN x 128 tiles
  float* scale_ring = reinterpret_cast<float*>(wide + (WBITS == 4 ? 2 * BN * PF_BK : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(scale_ring) + (F64 ? STAGES * pf_scale_bytes<BN>() : 0));
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int m0 = blockIdx.x * PF_BM, n0 = blockIdx.y * BN;
  const int ksteps = K / 32;  // 32-byte k-steps; K % 64 == 0
  const int kt = (ksteps + 3) / 4;  // stages
  const int steps_per_group = GROUPED ? group / 32 : 0;

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
    if (tid < 256 + (F64 ? 32 : 1)) {  // one thread; K9 grouped: the warp (scale rows)
      for (int i = 0; i < kt; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        if constexpr (F64) {
          // the scale row of a group that ends after k-step 4 i + 2 q + 1
          // goes to slot q (cp.async, zeros past N; counted on full[s])
          float* slots = scale_ring + s * 2 * BN;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int ks = 4 * i + 2 * q + 1;
            if (ks < ksteps && (ks + 1) % steps_per_group == 0) {
              const float* row = scale + static_cast<size_t>(ks / steps_per_group) * N;
              for (int c = lane; c < BN; c += 32) {
                const bool in = n0 + c < N;
                cp_async_4(slots + q * BN + c, row + (in ? n0 + c : 0), in ? 4 : 0);
              }
            }
          }
          cp_async_arrive(&full[s]);
          __syncwarp();
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(smem + s * STAGE_BYTES, &tm_x, &full[s], i * PF_BK, m0);
          tma_load_2d(smem + s * STAGE_BYTES + A_BYTES, &tm_w, &full[s], i * PF_BK * WBITS / 8,
                      n0);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    reg_alloc<PF_CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int t = lane & 3;
    // one warp's release of stage s
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    int acc[NACC];
    using FoldT = typename std::conditional<F64, double, float>::type;
    FoldT facc[GROUPED ? NACC : 1];
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = 0;
    if constexpr (GROUPED) {
#pragma unroll
      for (int e = 0; e < NACC; ++e) facc[e] = 0;
    }

    if constexpr (PIPE) {
      // group 128: the group of stage i ends with its 4th k-step, its
      // scale row in slot 1
      auto fold = [&](int(&c)[NACC], int i) {
        const float* sg = scale_ring + (i % STAGES) * 2 * BN + BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const double s0 = sg[8 * j + 2 * t], s1 = sg[8 * j + 2 * t + 1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[4 * j + e] = __fma_rn(to_double(c[4 * j + e] >> 4), (e & 1) ? s1 : s0,
                                       facc[4 * j + e]);
          }
        }
        release(i % STAGES);
      };
      auto stage = [&](int(&cur)[NACC], int(&prev)[NACC], int i) {
        const int s = i % STAGES;
        mbar_wait(&full[s], (i / STAGES) & 1);
        const uint32_t a_addr = smem_u32(smem + s * STAGE_BYTES + wg * 64 * PF_BK);
        // both warpgroups are past stage i - 1, whose wait retired the
        // products of stage i - 2, the last to read wide[i % 2]
        unsigned char* dst = wide + (i & 1) * BN * PF_BK;
        consumers_sync();
        pf_widen<BN>(smem + s * STAGE_BYTES + A_BYTES, dst, tid);
        fence_proxy_async();
        consumers_sync();
        const uint32_t b_addr = smem_u32(dst);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pf_wgmma<BN>(cur, desc_kmajor_s8(a_addr, kk), desc_kmajor_s8(b_addr, kk), kk > 0);
        }
        wgmma_commit();
        if (i > 0) {  // stage i - 1's products are done: fold its group
          wgmma_wait<1>();
          fence_operands(prev);
          fold(prev, i - 1);
        }
      };
      int other[NACC];
      for (int i = 0; i < kt; i += 2) {
        stage(acc, other, i);
        if (i + 1 < kt) stage(other, acc, i + 1);
      }
      wgmma_wait<0>();
      if ((kt - 1) & 1) {
        fence_operands(other);
        fold(other, kt - 1);
      } else {
        fence_operands(acc);
        fold(acc, kt - 1);
      }
    }
    for (int i = 0; !PIPE && i < kt; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint32_t a_addr = smem_u32(smem + s * STAGE_BYTES + wg * 64 * PF_BK);
      uint32_t b_addr;
      if constexpr (WBITS == 4) {
        // both warpgroups are past stage i - 1, whose wait retired the
        // products of stage i - 2, the last to read wide[i % 2]
        unsigned char* dst = wide + (i & 1) * BN * PF_BK;
        consumers_sync();
        pf_widen<BN>(smem + s * STAGE_BYTES + A_BYTES, dst, tid);
        fence_proxy_async();
        consumers_sync();
        b_addr = smem_u32(dst);
      } else {
        b_addr = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
      }
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
            if ((ks + 1) % steps_per_group == 0) {  // a group ends: fold it
              wgmma_wait<0>();
              fence_operands(acc);
              if constexpr (F64) {
                const float* sg = scale_ring + s * 2 * BN + (kk >> 1) * BN;
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
                  const double s0 = sg[8 * j + 2 * t], s1 = sg[8 * j + 2 * t + 1];
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    facc[4 * j + e] = __fma_rn(to_double(acc[4 * j + e] >> 4),
                                               (e & 1) ? s1 : s0, facc[4 * j + e]);
                  }
                }
              } else {
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
          if constexpr (F64) {
            y[e] = __fmul_rn(__double2float_rn(facc[4 * j + 2 * h + e]), as);
          } else if constexpr (GROUPED) {
            y[e] = __fmul_rn(facc[4 * j + 2 * h + e], as);
          } else {
            // K9's widened codes are 16 times theirs (`unpack_int4x16_x16`)
            const int v = WBITS == 4 ? acc[4 * j + 2 * h + e] >> 4 : acc[4 * j + 2 * h + e];
            y[e] = __fmul_rn(__fmul_rn(__int2float_rn(v), as), scale[c]);
          }
          if (bias != nullptr) y[e] = __fadd_rn(y[e], bias[c]);
        }
        store_pair(out, m, n, N, y[0], y[1]);
      }
    }
  }
}

template <int WBITS, int BN, bool GROUPED, bool PIPE = false>
cudaError_t launch_prefill(const CUtensorMap& tx, const CUtensorMap& tw, const float* a_scale,
                           const float* scale, const float* bias, __nv_bfloat16* out, int M,
                           int N, int K, int group, cudaStream_t stream) {
  const size_t smem = pf_smem_bytes<WBITS, BN, GROUPED>();
  cudaError_t err = cudaFuncSetAttribute(prefill_kernel<WBITS, BN, GROUPED, PIPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + PF_BM - 1) / PF_BM, (N + BN - 1) / BN);
  prefill_kernel<WBITS, BN, GROUPED, PIPE>
      <<<grid, PF_THREADS, smem, stream>>>(tx, tw, a_scale, scale, bias, out, M, N, K, group);
  return cudaGetLastError();
}

// Tensor map of K9's packed codes (rows, row_bytes) in boxes of 64 bytes
// (128 k) x box_rows rows, without swizzle (the consumers read them with
// plain loads). row_bytes must be a multiple of 16; a box that runs past
// the last row or column is zero-filled.
inline cudaError_t packed_map(CUtensorMap* map, const void* base, int rows, int row_bytes,
                              int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = hopper::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The prefill tiles' tensor maps and launch. K6b: 128 x 256 output tiles
// where N > 1024 (each activation line read for twice the outputs), else
// 128 x 128 (256-wide tiles leave SMs idle below ~1,000 columns); grouped
// scales take 128 (their fp32 sums double the accumulator registers). K9:
// 128 x 128 per channel, 128 x 64 grouped (the fp64 group sums double the
// accumulator registers again).
template <int WBITS>
cudaError_t prefill(const int8_t* x, const float* a, const void* w, const float* sc,
                    const float* b, __nv_bfloat16* o, int M, int N, int K, int group,
                    cudaStream_t s) {
  CUtensorMap tx, tw;
  cudaError_t err = hopper::int8_map(&tx, x, M, K, PF_BM);
  if constexpr (WBITS == 4) {
    if (err == cudaSuccess) err = packed_map(&tw, w, N, K / 2, group ? 64 : 128);
    if (err != cudaSuccess) return err;
    if (group == PF_BK) {
      return launch_prefill<4, 64, true, true>(tx, tw, a, sc, b, o, M, N, K, group, s);
    }
    if (group) return launch_prefill<4, 64, true>(tx, tw, a, sc, b, o, M, N, K, group, s);
    return launch_prefill<4, 128, false>(tx, tw, a, sc, b, o, M, N, K, 0, s);
  } else {
    const int block_n = !group && N > 1024 ? 256 : 128;
    if (err == cudaSuccess) err = hopper::int8_map(&tw, w, N, K, block_n);
    if (err != cudaSuccess) return err;
    if (group) return launch_prefill<8, 128, true>(tx, tw, a, sc, b, o, M, N, K, group, s);
    if (block_n == 256) return launch_prefill<8, 256, false>(tx, tw, a, sc, b, o, M, N, K, 0, s);
    return launch_prefill<8, 128, false>(tx, tw, a, sc, b, o, M, N, K, 0, s);
  }
}

}  // namespace qgemm
