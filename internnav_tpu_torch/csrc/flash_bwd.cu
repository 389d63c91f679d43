// Flash-attention backward for Hopper (sm_90a): dK/dV (K2) and dQ (K3).
//
// Replaces the TPU Pallas kernels of internnav_tpu/ops/flash_attention.py
// (launched by `_flash_backward`):
// - `flash_bwd_dkv_kernel` replaces `_flash_bwd_dkv_kernel`:
//   dV = sum_q P^T dO and dK = sum_q dS^T Q per KV tile;
// - `flash_bwd_dq_kernel` replaces `_flash_bwd_dq_kernel`:
//   dQ = sum_k dS K per query tile.
// Both recompute P = exp(S * scale - lse) from the forward kernel's
// per-row logsumexp (`_recompute_p_ds`); rows with lse = -inf (no valid
// key) contribute 0; dS = P * (dP - D_i) * scale with dP = dO V^T and
// D_i = rowsum(dO * O) computed by the caller. Masks are the forward's:
// top-left causal (col <= row, Tq == Tk) and equal segment ids.
//
// Design (first, simple kernels; the TPU grids are not carried over):
// - K2: one block of 4 warps per (KV tile of 64 keys, KV head, batch); each
//   warp owns 16 keys. The block loops over the G = H / KV query heads of
//   its group and over the query tiles, with dK and dV accumulated in fp32
//   registers, so the grouped-query sum needs no atomics and K2 writes
//   (B, KV, Tk, D) directly. The JAX package repeats K/V per query head
//   and sums afterwards.
// - K3: one block of 4 warps per (query tile of 64 rows, head, batch),
//   looping over the KV tiles, dQ in fp32 registers.
// - The TPU's sequential reduction grid axis is the loop inside the block.
//   Whole tiles removed by the causal mask are skipped (as `:274-278` and
//   `:327-330`); ragged T is masked inside (zero-filled tiles, index
//   checks), so any length runs.
// - Products run on the tensor cores through mma.sync m16n8k16 (bf16
//   operands, fp32 accumulate). P and dS round to bf16 as operands of the
//   second products, as on the TPU. Operand fragments are read from shared
//   memory inside the loops rather than kept in registers, which keeps the
//   fp32 accumulators (K2: 2 x 16 x D per warp) within the register file.
//
// What bounds it on an H100: the least time for the work (`bound_ms` in
// chip_smoke.py) is set by bytes: at the training shape (T = 8192, D = 128,
// 28 heads, a packed row of ~220-token segments) the flops of the valid
// (q, k) pairs (K2 8*D, K3 6*D per pair) take less time at the tensor-core
// peak than reading q, k, v, dO, lse and D_i once and writing the
// gradients once takes at the memory rate. What limits
// these kernels is their mma.sync rate over every causal tile: they skip
// no tile by segment range, so they compute ~35x the valid pairs, reach
// the tensor cores only through mma.sync with synchronous tile loads and
// scalar loads for the transposed operands, and K2's blocks carry uneven
// causal work (the first KV tile sees every query tile, the last one a
// single tile). Segment-range tile skipping, ldmatrix(.trans), cp.async/TMA
// double buffering and wgmma are later optimisations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;      // query rows per tile
constexpr int BLOCK_N = 64;      // keys per tile
constexpr int NUM_THREADS = 128; // 4 warps x 16 rows
constexpr int PAD = 8;           // bf16 elements of padding per smem row
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;        // (B, H, Tq, D)
  const __nv_bfloat16* k;        // (B, KV, Tk, D)
  const __nv_bfloat16* v;        // (B, KV, Tk, D)
  const __nv_bfloat16* dout;     // (B, H, Tq, D)
  const float* lse;              // (B, H, Tq), natural log, -inf on empty rows
  const float* di;               // (B, H, Tq), rowsum(dO * O)
  const int* q_seg;              // (B, Tq) or null
  const int* kv_seg;             // (B, Tk) or null
  __nv_bfloat16* dq;             // (B, H, Tq, D)
  __nv_bfloat16* dk;             // (B, KV, Tk, D)
  __nv_bfloat16* dv;             // (B, KV, Tk, D)
  int H, KV, Tq, Tk;
  float scale;                   // sm_scale
  float scale_log2;              // sm_scale * log2(e)
  int causal;
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one m16n8k16 tile (a: 16x16 row-major, b: 16x8 col-major).
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a 16x16 tile whose rows are smem rows (row stride LDS):
// rows row0 + {g, g + 8}, columns col0 + {2 tig, 2 tig + 1, +8, +9}.
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s, int row0, int col0,
                                       int g, int tig) {
  const __nv_bfloat16* base = s + (row0 + g) * LDS + col0 + tig * 2;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * LDS);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * LDS + 8);
}

// B fragment (16 deep x 8 wide) of X^T where X's rows are smem rows: the 8
// output columns are X rows row0 + g, the depth is X columns col0 + ...
template <int LDS>
__device__ __forceinline__ void load_b_rows(uint32_t* b, const __nv_bfloat16* s, int row0,
                                            int col0, int g, int tig) {
  const __nv_bfloat16* base = s + (row0 + g) * LDS + col0 + tig * 2;
  b[0] = ld32(base);
  b[1] = ld32(base + 8);
}

// B fragment (16 deep x 8 wide) of X itself: depth runs down X's smem rows
// row0 + ..., the 8 output columns are X columns col0 + g.
template <int LDS>
__device__ __forceinline__ void load_b_cols(uint32_t* b, const __nv_bfloat16* s, int row0,
                                            int col0, int g, int tig) {
  const __nv_bfloat16* base = s + (row0 + tig * 2) * LDS + col0 + g;
  b[0] = pack2(base[0], base[LDS]);
  b[1] = pack2(base[8 * LDS], base[9 * LDS]);
}

// rows x D tile from global (row stride D) into smem (row stride D + PAD);
// rows at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows, int limit) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + col) = val;
  }
}

// store one warp's 16 x D fp32 accumulator (C fragments) as bf16 rows
// row0 + {g, g + 8} of a (rows, D) matrix; rows at or past `limit` skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (*acc)[4], int row0,
                                           int limit, int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
    __nv_bfloat16* out = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8 + tig * 2) =
          pack_f32(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- K2: dK, dV
template <int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LDS = D + PAD;
  constexpr int KSTEPS = D / 16;   // k-steps over the head dim
  constexpr int DTILES = D / 8;    // n-tiles over the head dim
  constexpr int HALF = BLOCK_M / 2;  // queries per inner pass (register budget)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BLOCK_N * LDS;
  __nv_bfloat16* sQ = sV + BLOCK_N * LDS;
  __nv_bfloat16* sdO = sQ + BLOCK_M * LDS;
  float* sLse2 = reinterpret_cast<float*>(sdO + BLOCK_M * LDS);
  float* sDi = sLse2 + BLOCK_M;
  int* sQseg = reinterpret_cast<int*>(sDi + BLOCK_M);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int n_start = blockIdx.x * BLOCK_N;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const bool has_seg = p.q_seg != nullptr;
  const int m0 = warp * 16;  // this warp's keys within the tile

  const size_t kv_off = static_cast<size_t>(b * p.KV + kvh) * p.Tk * D;
  load_tile<D>(sK, p.k + kv_off, n_start, BLOCK_N, p.Tk);
  load_tile<D>(sV, p.v + kv_off, n_start, BLOCK_N, p.Tk);

  // each thread's two key rows (C-fragment rows g and g + 8)
  const int key[2] = {n_start + m0 + g, n_start + m0 + g + 8};
  int kseg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      kseg[r] = key[r] < p.Tk ? p.kv_seg[static_cast<size_t>(b) * p.Tk + key[r]] : 0;
    }
  }

  float dk[DTILES][4];
  float dv[DTILES][4];
#pragma unroll
  for (int n = 0; n < DTILES; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }

  // causal: a query tile holds a valid (row >= col) pair only from the
  // tile containing the first key on (BLOCK_M == BLOCK_N)
  const int m_begin = p.causal ? n_start : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const size_t q_off = static_cast<size_t>(b * p.H + h) * p.Tq;
    for (int m_start = m_begin; m_start < p.Tq; m_start += BLOCK_M) {
      __syncthreads();  // every warp is done with the previous Q / dO tile
      load_tile<D>(sQ, p.q + q_off * D, m_start, BLOCK_M, p.Tq);
      load_tile<D>(sdO, p.dout + q_off * D, m_start, BLOCK_M, p.Tq);
      for (int i = threadIdx.x; i < BLOCK_M; i += NUM_THREADS) {
        const int row = m_start + i;
        const bool in = row < p.Tq;
        sLse2[i] = in ? p.lse[q_off + row] * LOG2E : -INFINITY;
        sDi[i] = in ? p.di[q_off + row] : 0.f;
        if (has_seg) sQseg[i] = in ? p.q_seg[static_cast<size_t>(b) * p.Tq + row] : 0;
      }
      __syncthreads();

#pragma unroll 1
      for (int half = 0; half < BLOCK_M / HALF; ++half) {
        const int c0 = half * HALF;
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries per warp
        float st[HALF / 8][4];
        float dpt[HALF / 8][4];
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t ka[4], va[4];
          load_a<LDS>(ka, sK, m0, kk * 16, g, tig);
          load_a<LDS>(va, sV, m0, kk * 16, g, tig);
#pragma unroll
          for (int j = 0; j < HALF / 8; ++j) {
            uint32_t bq[2], bdo[2];
            load_b_rows<LDS>(bq, sQ, c0 + j * 8, kk * 16, g, tig);
            load_b_rows<LDS>(bdo, sdO, c0 + j * 8, kk * 16, g, tig);
            mma16816(st[j], ka, bq);
            mma16816(dpt[j], va, bdo);
          }
        }

        // P^T and dS^T in place (masked entries 0)
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int c = c0 + j * 8 + tig * 2 + (e & 1);
            const float lse2 = sLse2[c];
            bool ok = key[r] < p.Tk && lse2 != -INFINITY;
            if (p.causal) ok = ok && key[r] <= m_start + c;
            if (has_seg) ok = ok && sQseg[c] == kseg[r];
            const float pe = ok ? exp2f(st[j][e] * p.scale_log2 - lse2) : 0.f;
            st[j][e] = pe;
            dpt[j][e] = pe * (dpt[j][e] - sDi[c]) * p.scale;
          }
        }

        // dV += P^T dO and dK += dS^T Q over this pass's 32 queries
#pragma unroll
        for (int ks = 0; ks < HALF / 16; ++ks) {
          const uint32_t pa[4] = {
              pack_f32(st[2 * ks][0], st[2 * ks][1]),
              pack_f32(st[2 * ks][2], st[2 * ks][3]),
              pack_f32(st[2 * ks + 1][0], st[2 * ks + 1][1]),
              pack_f32(st[2 * ks + 1][2], st[2 * ks + 1][3]),
          };
          const uint32_t dsa[4] = {
              pack_f32(dpt[2 * ks][0], dpt[2 * ks][1]),
              pack_f32(dpt[2 * ks][2], dpt[2 * ks][3]),
              pack_f32(dpt[2 * ks + 1][0], dpt[2 * ks + 1][1]),
              pack_f32(dpt[2 * ks + 1][2], dpt[2 * ks + 1][3]),
          };
#pragma unroll
          for (int n = 0; n < DTILES; ++n) {
            uint32_t bdo[2], bq[2];
            load_b_cols<LDS>(bdo, sdO, c0 + ks * 16, n * 8, g, tig);
            load_b_cols<LDS>(bq, sQ, c0 + ks * 16, n * 8, g, tig);
            mma16816(dv[n], pa, bdo);
            mma16816(dk[n], dsa, bq);
          }
        }
      }
    }
  }

  store_rows<D>(p.dk + kv_off, dk, n_start + m0, p.Tk, g, tig);
  store_rows<D>(p.dv + kv_off, dv, n_start + m0, p.Tk, g, tig);
}

// ---------------------------------------------------------------- K3: dQ
template <int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int LDS = D + PAD;
  constexpr int KSTEPS = D / 16;
  constexpr int DTILES = D / 8;
  constexpr int NTILES = BLOCK_N / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + BLOCK_M * LDS;
  __nv_bfloat16* sK = sdO + BLOCK_M * LDS;
  __nv_bfloat16* sV = sK + BLOCK_N * LDS;
  int* sKseg = reinterpret_cast<int*>(sV + BLOCK_N * LDS);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int q_start = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const bool has_seg = p.q_seg != nullptr;
  const int m0 = warp * 16;

  const size_t q_off = static_cast<size_t>(b * p.H + h) * p.Tq;
  const size_t kv_off = static_cast<size_t>(b * p.KV + kvh) * p.Tk * D;
  load_tile<D>(sQ, p.q + q_off * D, q_start, BLOCK_M, p.Tq);
  load_tile<D>(sdO, p.dout + q_off * D, q_start, BLOCK_M, p.Tq);

  const int row[2] = {q_start + m0 + g, q_start + m0 + g + 8};
  float lse2[2], di[2];
  int seg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.Tq;
    lse2[r] = in ? p.lse[q_off + row[r]] * LOG2E : -INFINITY;
    di[r] = in ? p.di[q_off + row[r]] : 0.f;
    if (has_seg && in) seg[r] = p.q_seg[static_cast<size_t>(b) * p.Tq + row[r]];
  }

  float acc[DTILES][4];
#pragma unroll
  for (int n = 0; n < DTILES; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  const int n_end = p.causal ? min(p.Tk, q_start + BLOCK_M) : p.Tk;
  for (int n_start = 0; n_start < n_end; n_start += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, p.k + kv_off, n_start, BLOCK_N, p.Tk);
    load_tile<D>(sV, p.v + kv_off, n_start, BLOCK_N, p.Tk);
    if (has_seg) {
      for (int i = threadIdx.x; i < BLOCK_N; i += NUM_THREADS) {
        const int col = n_start + i;
        sKseg[i] = col < p.Tk ? p.kv_seg[static_cast<size_t>(b) * p.Tk + col] : 0;
      }
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[NTILES][4];
    float dp[NTILES][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], doa[4];
      load_a<LDS>(qa, sQ, m0, kk * 16, g, tig);
      load_a<LDS>(doa, sdO, m0, kk * 16, g, tig);
#pragma unroll
      for (int j = 0; j < NTILES; ++j) {
        uint32_t bk[2], bv[2];
        load_b_rows<LDS>(bk, sK, j * 8, kk * 16, g, tig);
        load_b_rows<LDS>(bv, sV, j * 8, kk * 16, g, tig);
        mma16816(s[j], qa, bk);
        mma16816(dp[j], doa, bv);
      }
    }

    // dS in place of dP (masked entries 0)
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = j * 8 + tig * 2 + (e & 1);
        const int col = n_start + c;
        bool ok = col < p.Tk && lse2[r] != -INFINITY;
        if (p.causal) ok = ok && col <= row[r];
        if (has_seg) ok = ok && sKseg[c] == seg[r];
        const float pe = ok ? exp2f(s[j][e] * p.scale_log2 - lse2[r]) : 0.f;
        dp[j][e] = pe * (dp[j][e] - di[r]) * p.scale;
      }
    }

    // dQ += dS K: two dS n-tiles form one A fragment over 16 keys
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t dsa[4] = {
          pack_f32(dp[2 * kk][0], dp[2 * kk][1]),
          pack_f32(dp[2 * kk][2], dp[2 * kk][3]),
          pack_f32(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_f32(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < DTILES; ++n) {
        uint32_t bk[2];
        load_b_cols<LDS>(bk, sK, kk * 16, n * 8, g, tig);
        mma16816(acc[n], dsa, bk);
      }
    }
  }

  store_rows<D>(p.dq + q_off * D, acc, q_start + m0, p.Tq, g, tig);
}

template <int D>
size_t smem_bytes() {
  return static_cast<size_t>(BLOCK_M + BLOCK_N) * 2 * (D + PAD) * sizeof(__nv_bfloat16) +
         3 * BLOCK_M * sizeof(float);
}

template <int D>
cudaError_t launch_dkv(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tk + BLOCK_N - 1) / BLOCK_N, p.KV, B);
  flash_bwd_dkv_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BLOCK_M - 1) / BLOCK_M, p.H, B);
  flash_bwd_dq_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* di, const void* q_seg, const void* kv_seg,
                   int H, int KV, int Tq, int Tk, float sm_scale, int causal) {
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.H = H;
  p.KV = KV;
  p.Tq = Tq;
  p.Tk = Tk;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * LOG2E;
  p.causal = causal;
  return p;
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). The wrapper has checked shapes, dtypes, contiguity and
// alignment.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* di,
                                  const void* q_seg, const void* kv_seg, void* dk, void* dv,
                                  int B, int H, int KV, int Tq, int Tk, int D,
                                  float sm_scale, int causal, void* stream) {
  Params p = make_params(q, k, v, dout, lse, di, q_seg, kv_seg, H, KV, Tq, Tk, sm_scale, causal);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80:
      return static_cast<int>(launch_dkv<80>(p, B, s));
    case 128:
      return static_cast<int>(launch_dkv<128>(p, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* di,
                                 const void* q_seg, const void* kv_seg, void* dq,
                                 int B, int H, int KV, int Tq, int Tk, int D,
                                 float sm_scale, int causal, void* stream) {
  Params p = make_params(q, k, v, dout, lse, di, q_seg, kv_seg, H, KV, Tq, Tk, sm_scale, causal);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80:
      return static_cast<int>(launch_dq<80>(p, B, s));
    case 128:
      return static_cast<int>(launch_dq<128>(p, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
