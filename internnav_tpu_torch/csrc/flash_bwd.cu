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
// top-left causal (col <= row, Tq == Tk) and equal segment ids. bf16 in and
// out, P and dS rounded to bf16 as operands, fp32 accumulation.
//
// What bounds them on an H100 (`bound_ms` in chip_smoke.py): bytes. At the
// training shape (T = 8192, D = 128, 28 heads over 4 KV heads, a packed row
// of ~220-token segments) the flops of the valid (q, k) pairs (K2 8 D, K3
// 6 D per pair) take less time at the 989 TFLOP/s tensor-core peak than
// reading q, k, v, dO, lse and D_i once and writing the gradients once
// takes at 3.35 TB/s. On a dense causal row the flops bound them instead.
//
// Design:
// - Work. A tile pair (64 queries x 64 keys) is computed only when it is
//   live: causally live, and its segment ranges overlap. The caller passes
//   one table per side (`tile_segment_ranges` in ops/flash_attention.py):
//   per 64-row tile, [lo, hi] over the ids >= 0 and [lo, hi] over the ids
//   < 0, so a pad tail (-1) does not widen the range of the sample it
//   follows. A dropped pair holds no (q, k) with equal ids, so it would
//   only have added exact zeros. Each block builds the list of its live
//   tiles in shared memory once and walks only that list.
// - Rate. One warpgroup (128 threads) per block. Operand tiles arrive by
//   TMA (3-D tensor maps, 128-byte swizzle; rows past T and columns past
//   D arrive as zeros, so the ragged tail and D = 80 need no separate
//   path) into a 2-stage ring with mbarriers: one elected thread issues
//   the next work item's copies before the current item's products run.
//   All products run on wgmma: S and dP (m64n64k16) with both operands in
//   shared memory, the gradient products (m64n128k16) with P or dS as the
//   register A operand, repacked from the accumulators to bf16, and B
//   read transposed (MN-major) from the same shared tiles.
// - K2: one block per (64-key tile, KV head, batch). K and V are loaded
//   once; the block walks (live query tile x the G = H / KV query heads
//   of its group) as one flat sequence of items (Q, dO, lse and D_i rows
//   per item), with dK and dV in fp32 registers over the whole walk, so
//   the grouped-query sum needs no atomics and no (B, H, T, D) buffer.
// - K3: one block per (64-query tile, head, batch). Q, dO, lse and D_i are
//   loaded once; K and V tiles stream through the ring.
// - Balance: blocks are issued heaviest first. Under the causal mask K2's
//   key tile 0 sees every query tile and K3's last query tile sees every
//   key tile, so K2 runs its tiles in order and K3 in reverse, with the
//   tile index the slowest grid dimension.
// - D = 80 (vision windows) runs the same kernels: its tensor maps are 80
//   columns wide and the TMA box's columns 80-127 arrive as zeros.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK = 64;         // query rows and keys per tile
constexpr int NUM_THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* lse;     // (B, H, Tq_pad), natural log, -inf on empty and pad rows
  const float* di;      // (B, H, Tq_pad), rowsum(dO * O)
  const int* q_seg;     // (B, Tq_pad) or null
  const int* kv_seg;    // (B, Tk_pad) or null
  const int4* q_tab;    // (B, n_qt) segment ranges of the query tiles, or null
  const int4* kv_tab;   // (B, n_kt) of the key tiles, or null
  __nv_bfloat16* dq;    // (B, H, Tq, D)
  __nv_bfloat16* dk;    // (B, KV, Tk, D)
  __nv_bfloat16* dv;    // (B, KV, Tk, D)
  int H, KV, Tq, Tk, D;
  int n_qt, n_kt;       // tiles; the padded lengths are 64 n_qt and 64 n_kt
  float scale;          // sm_scale
  float scale_log2;     // sm_scale * log2(e)
  int causal;
};

// per-item rows of K2's ring: lse, D_i and segment ids of 64 queries
struct QueryRows {
  float lse[BLOCK];
  float di[BLOCK];
  int seg[BLOCK];
};

// The tiles i in [begin, end) whose ranges overlap `mine` (all of them
// when `tab` is null), in order, into `list`; returns their count. Called
// by every thread of the block.
__device__ int live_list(int* list, int* warp_counts, const int4* tab, int4 mine, int begin,
                         int end) {
  return build_live_list<NUM_THREADS>(list, warp_counts, begin, end, [&](int i) {
    return tab == nullptr || ranges_overlap(mine, tab[i]) ? i : -1;
  });
}

// ---------------------------------------------------------------- K2: dK, dV
__global__ void __launch_bounds__(NUM_THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + TILE_BYTES;
  unsigned char* sQ = smem + 2 * TILE_BYTES;   // stage s at + s * TILE_BYTES
  unsigned char* sdO = smem + 4 * TILE_BYTES;  // likewise
  QueryRows* rows = reinterpret_cast<QueryRows*>(smem + 6 * TILE_BYTES);  // [2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + 2);  // K/V, then the ring's 2
  int* warp_counts = reinterpret_cast<int*>(bars + 3);
  int* list = warp_counts + NUM_THREADS / 32;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int bk = blockIdx.x;  // b * KV + kv head
  const int b = bk / p.KV;
  const int kvh = bk % p.KV;
  const int kt = blockIdx.y;  // causal: tile 0 sees every query tile, so it goes first
  const int n_start = kt * BLOCK;
  const int G = p.H / p.KV;
  const bool has_seg = p.q_seg != nullptr;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(&bars[0], 2 * TILE_BYTES);
    tma_load_tile(sK, &tm_k, &bars[0], n_start, bk);
    tma_load_tile(sV, &tm_v, &bars[0], n_start, bk);
  }
  __syncthreads();

  // live query tiles: causal keeps tiles kt.. (a key sees rows at or after
  // it), segment ranges keep the overlapping ones
  const int4 mine = has_seg ? p.kv_tab[b * p.n_kt + kt] : make_int4(0, 0, 0, 0);
  const int n_live = live_list(list, warp_counts, has_seg ? p.q_tab + b * p.n_qt : nullptr,
                               mine, p.causal ? kt : 0, p.n_qt);
  const int n_items = n_live * G;
  const int q_pad = p.n_qt * BLOCK;

  // item -> (query tile list[item / G], head kvh * G + item % G) into stage s
  auto issue = [&](int item, int s) {
    const int m_start = list[item / G] * BLOCK;
    const int bh = b * p.H + kvh * G + item % G;
    uint64_t* bar = &bars[1 + s];
    mbar_arrive_expect_tx(bar, 2 * TILE_BYTES + (has_seg ? 3 : 2) * BLOCK * 4);
    tma_load_tile(sQ + s * TILE_BYTES, &tm_q, bar, m_start, bh);
    tma_load_tile(sdO + s * TILE_BYTES, &tm_do, bar, m_start, bh);
    bulk_load(rows[s].lse, p.lse + static_cast<size_t>(bh) * q_pad + m_start, BLOCK * 4, bar);
    bulk_load(rows[s].di, p.di + static_cast<size_t>(bh) * q_pad + m_start, BLOCK * 4, bar);
    if (has_seg) {
      bulk_load(rows[s].seg, p.q_seg + static_cast<size_t>(b) * q_pad + m_start, BLOCK * 4, bar);
    }
  };
  if (tid == 0 && n_items > 0) issue(0, 0);

  // this thread's two keys (accumulator rows g and g + 8 of its warp)
  int key[2], kseg[2];
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = n_start + 16 * warp + g + 8 * r;
    key_ok[r] = key[r] < p.Tk;
    kseg[r] = has_seg ? p.kv_seg[static_cast<size_t>(b) * p.n_kt * BLOCK + key[r]] : 0;
  }

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&bars[0], 0);
  const uint32_t k_addr = smem_u32(sK);
  const uint32_t v_addr = smem_u32(sV);

#pragma unroll 1
  for (int it = 0; it < n_items; ++it) {
    const int s = it & 1;
    __syncthreads();  // every thread is done with item it - 1, which used stage s ^ 1
    if (tid == 0 && it + 1 < n_items) issue(it + 1, s ^ 1);
    mbar_wait(&bars[1 + s], (it >> 1) & 1);
    const int m_start = list[it / G] * BLOCK;
    const uint32_t q_addr = smem_u32(sQ + s * TILE_BYTES);
    const uint32_t do_addr = smem_u32(sdO + s * TILE_BYTES);
    const QueryRows& qr = rows[s];

    // S^T = K Q^T and dP^T = V dO^T (keys x queries), one group each
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_m64n64k16_ss(st, desc_kmajor(k_addr, kk), desc_kmajor(q_addr, kk), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_m64n64k16_ss(dpt, desc_kmajor(v_addr, kk), desc_kmajor(do_addr, kk), kk);
    }
    wgmma_commit();

    // P^T in place of S^T (masked entries 0) while dP^T runs
    wgmma_wait<1>();
    fence_operands(st);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);
      const float lse = qr.lse[c];
      bool ok = key_ok[r] && lse != -INFINITY;
      if (p.causal) ok = ok && key[r] <= m_start + c;
      if (has_seg) ok = ok && qr.seg[c] == kseg[r];
      st[i] = ok ? exp2f(fmaf(st[i], p.scale_log2, -lse * LOG2E)) : 0.f;
    }

    // dS^T = P^T (dP^T - D_i) scale; both repacked as bf16 A operands
    wgmma_wait<0>();
    fence_operands(dpt);
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = 8 * kk + e;
        const int c = 8 * (i >> 2) + 2 * t + (i & 1);
        dpt[i] = st[i] * (dpt[i] - qr.di[c]) * p.scale;
      }
      acc_to_a(pa[kk], st, kk);
      acc_to_a(dsa[kk], dpt, kk);
    }

    // dV += P^T dO and dK += dS^T Q (keys x D), B read transposed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_rs(dv, pa[kk], desc_mnmajor(do_addr, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_rs(dk, dsa[kk], desc_mnmajor(q_addr, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv);
    fence_operands(dk);
  }

  const size_t kv_off = static_cast<size_t>(bk) * p.Tk * p.D;
  const int row0 = n_start + 16 * warp + g;
  store_acc(p.dk + kv_off, dk, row0, p.Tk, p.D);
  store_acc(p.dv + kv_off, dv, row0, p.Tk, p.D);
}

// ---------------------------------------------------------------- K3: dQ
__global__ void __launch_bounds__(NUM_THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sdO = smem + TILE_BYTES;
  unsigned char* sK = smem + 2 * TILE_BYTES;  // stage s at + s * TILE_BYTES
  unsigned char* sV = smem + 4 * TILE_BYTES;  // likewise
  int* kseg = reinterpret_cast<int*>(smem + 6 * TILE_BYTES);  // [2][BLOCK]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kseg + 2 * BLOCK);  // Q/dO, then the ring's 2
  int* warp_counts = reinterpret_cast<int*>(bars + 3);
  int* list = warp_counts + NUM_THREADS / 32;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int bh = blockIdx.x;  // b * H + head
  const int b = bh / p.H;
  const int bk = b * p.KV + (bh % p.H) / (p.H / p.KV);
  // causal: the last query tile sees every key tile, so it goes first
  const int qt = p.causal ? p.n_qt - 1 - blockIdx.y : blockIdx.y;
  const int q_start = qt * BLOCK;
  const bool has_seg = p.q_seg != nullptr;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(&bars[0], 2 * TILE_BYTES);
    tma_load_tile(sQ, &tm_q, &bars[0], q_start, bh);
    tma_load_tile(sdO, &tm_do, &bars[0], q_start, bh);
  }
  __syncthreads();

  const int4 mine = has_seg ? p.q_tab[b * p.n_qt + qt] : make_int4(0, 0, 0, 0);
  const int n_live = live_list(list, warp_counts, has_seg ? p.kv_tab + b * p.n_kt : nullptr,
                               mine, 0, p.causal ? min(qt + 1, p.n_kt) : p.n_kt);
  const int k_pad = p.n_kt * BLOCK;

  auto issue = [&](int item, int s) {
    const int n_start = list[item] * BLOCK;
    uint64_t* bar = &bars[1 + s];
    mbar_arrive_expect_tx(bar, 2 * TILE_BYTES + (has_seg ? BLOCK * 4 : 0));
    tma_load_tile(sK + s * TILE_BYTES, &tm_k, bar, n_start, bk);
    tma_load_tile(sV + s * TILE_BYTES, &tm_v, bar, n_start, bk);
    if (has_seg) {
      bulk_load(kseg + s * BLOCK, p.kv_seg + static_cast<size_t>(b) * k_pad + n_start, BLOCK * 4,
                bar);
    }
  };
  if (tid == 0 && n_live > 0) issue(0, 0);

  // this thread's two query rows (accumulator rows g and g + 8 of its warp)
  const size_t stat_off = static_cast<size_t>(bh) * p.n_qt * BLOCK;
  int row[2], qseg[2];
  float lse2[2], di[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q_start + 16 * warp + g + 8 * r;
    const float lse = p.lse[stat_off + row[r]];
    row_ok[r] = lse != -INFINITY;
    lse2[r] = lse * LOG2E;
    di[r] = p.di[stat_off + row[r]];
    qseg[r] = has_seg ? p.q_seg[static_cast<size_t>(b) * p.n_qt * BLOCK + row[r]] : 0;
  }

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;

  mbar_wait(&bars[0], 0);
  const uint32_t q_addr = smem_u32(sQ);
  const uint32_t do_addr = smem_u32(sdO);

#pragma unroll 1
  for (int it = 0; it < n_live; ++it) {
    const int s = it & 1;
    __syncthreads();  // every thread is done with item it - 1, which used stage s ^ 1
    if (tid == 0 && it + 1 < n_live) issue(it + 1, s ^ 1);
    mbar_wait(&bars[1 + s], (it >> 1) & 1);
    const int n_start = list[it] * BLOCK;
    const uint32_t k_addr = smem_u32(sK + s * TILE_BYTES);
    const uint32_t v_addr = smem_u32(sV + s * TILE_BYTES);
    const int* ks = kseg + s * BLOCK;

    // S = Q K^T and dP = dO V^T (queries x keys), one group each
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_m64n64k16_ss(sc, desc_kmajor(q_addr, kk), desc_kmajor(k_addr, kk), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_m64n64k16_ss(dp, desc_kmajor(do_addr, kk), desc_kmajor(v_addr, kk), kk);
    }
    wgmma_commit();

    // P in place of S (masked entries 0) while dP runs
    wgmma_wait<1>();
    fence_operands(sc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);
      const int col = n_start + c;
      bool ok = row_ok[r] && col < p.Tk;
      if (p.causal) ok = ok && col <= row[r];
      if (has_seg) ok = ok && ks[c] == qseg[r];
      sc[i] = ok ? exp2f(fmaf(sc[i], p.scale_log2, -lse2[r])) : 0.f;
    }

    // dS = P (dP - D_i) scale, repacked as the bf16 A operand of dQ += dS K
    wgmma_wait<0>();
    fence_operands(dp);
    uint32_t dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = 8 * kk + e;
        dp[i] = sc[i] * (dp[i] - di[(i >> 1) & 1]) * p.scale;
      }
      acc_to_a(dsa[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_rs(dq, dsa[kk], desc_mnmajor(k_addr, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
  }

  store_acc(p.dq + static_cast<size_t>(bh) * p.Tq * p.D, dq, q_start + 16 * warp + g, p.Tq, p.D);
}

// K2's and K3's shared memory: six tiles, the ring's rows, barriers, the
// warp counts and the live list
size_t smem_bytes(int list_len) {
  return 1024 + 6 * TILE_BYTES + 2 * sizeof(QueryRows) + 3 * sizeof(uint64_t) +
         (NUM_THREADS / 32 + list_len) * sizeof(int);
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                      int B, int H, int KV, int Tq, int Tk, int D) {
  cudaError_t err = tile_map(&m->q, q, B * H, Tq, D);
  if (err == cudaSuccess) err = tile_map(&m->dout, dout, B * H, Tq, D);
  if (err == cudaSuccess) err = tile_map(&m->k, k, B * KV, Tk, D);
  if (err == cudaSuccess) err = tile_map(&m->v, v, B * KV, Tk, D);
  return err;
}

Params make_params(const void* lse, const void* di, const void* q_seg, const void* kv_seg,
                   const void* q_tab, const void* kv_tab, int H, int KV, int Tq, int Tk, int D,
                   float sm_scale, int causal) {
  Params p = {};
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.q_tab = static_cast<const int4*>(q_tab);
  p.kv_tab = static_cast<const int4*>(kv_tab);
  p.H = H;
  p.KV = KV;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.n_qt = (Tq + BLOCK - 1) / BLOCK;
  p.n_kt = (Tk + BLOCK - 1) / BLOCK;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * LOG2E;
  p.causal = causal;
  return p;
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). The wrapper has checked shapes, dtypes, contiguity and
// alignment, and hands lse, D_i and the segment ids padded to a multiple
// of 64 rows (lse -inf on the pad rows), with the tile tables of both
// segment id tensors when there are segment ids.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* di,
                                  const void* q_seg, const void* kv_seg, const void* q_tab,
                                  const void* kv_tab, void* dk, void* dv, int B, int H, int KV,
                                  int Tq, int Tk, int D, float sm_scale, int causal,
                                  void* stream) {
  if (D > hopper::TILE_COLS || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(lse, di, q_seg, kv_seg, q_tab, kv_tab, H, KV, Tq, Tk, D, sm_scale,
                         causal);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, B, H, KV, Tq, Tk, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(p.n_qt);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * KV, p.n_kt);
  flash_bwd_dkv_kernel<<<grid, NUM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      m.q, m.k, m.v, m.dout, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* di, const void* q_seg,
                                 const void* kv_seg, const void* q_tab, const void* kv_tab,
                                 void* dq, int B, int H, int KV, int Tq, int Tk, int D,
                                 float sm_scale, int causal, void* stream) {
  if (D > hopper::TILE_COLS || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(lse, di, q_seg, kv_seg, q_tab, kv_tab, H, KV, Tq, Tk, D, sm_scale,
                         causal);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, B, H, KV, Tq, Tk, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(p.n_kt);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, p.n_qt);
  flash_bwd_dq_kernel<<<grid, NUM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      m.q, m.k, m.v, m.dout, p);
  return static_cast<int>(cudaGetLastError());
}
