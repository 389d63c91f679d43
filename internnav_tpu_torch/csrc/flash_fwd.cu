// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state.
//
// Replaces the TPU Pallas kernel internnav_tpu/ops/flash_attention.py
// `_flash_kernel` (launched by `_flash_forward`). Same function: online-
// softmax attention with an fp32 accumulator, optional causal mask
// (top-left, col <= row, Tq == Tk), optional segment mask
// (q_seg[row] == kv_seg[col]), grouped-query K/V (query head h reads KV head
// h / (H / KV) in place), rows with no valid key give 0, and the per-row
// logsumexp (natural log, -inf for fully masked rows) that the backward
// kernels K2/K3 read.
//
// What bounds it on an H100 (`bound_ms` in chip_smoke.py): on a packed
// training row (T = 8192, segments of ~220 tokens) bytes, reading q, k, v
// once and writing o and lse once; on a dense causal row or a long prompt
// the flops of the valid (q, k) pairs (4 D per pair) at the 989 TFLOP/s
// tensor-core peak.
//
// Design:
// - Work. A work item is (128 query rows, head, batch). A 64-key tile is
//   walked only when it is live for either 64-row half of the item:
//   causally live, and the half's and the tile's segment ranges overlap
//   (`tile_segment_ranges` in ops/flash_attention.py: per 64-row tile,
//   [lo, hi] over the ids >= 0 and over the ids < 0; the tables K2/K3
//   read). The item's live tiles are compacted into a shared-memory list
//   with a warp ballot (`build_live_list`) and only the list is walked. A
//   tile live for one half only is masked for the other, and a fully
//   masked tile leaves the online softmax exactly as it was (row max
//   unchanged, alpha = 1, p = 0), so skipping dropped tiles changes nothing.
// - Persistent blocks. One block per SM walks items in a fixed order, so
//   one item's list, Q and first K/V tiles load while the previous item's
//   last products and stores run: a packed training row's items hold ~4
//   live tiles each, and a block per item spent more time starting and
//   ending than computing (scripts/torch/k1_persistence.py times the two:
//   built with -DFLASH_FWD_PERSISTENT=0 the same code runs one block per
//   item).
// - Warp specialisation. Three warpgroups: two consumers, each owning 64
//   query rows of the item, and a producer whose first warp builds each
//   item's list and whose first thread issues every load. The producer
//   gives registers back (setmaxnreg) and the consumers take them.
// - Loads. Q (128 x D) arrives by TMA into one of two slots per item (each
//   consumer thread reads its two rows' segment ids from global memory);
//   K and V tiles stream through a 4-stage ring of full / empty mbarriers,
//   with the tile's 64 key segment ids as a bulk copy beside them. 3-D tensor maps (D, T, B * heads), 128-byte swizzle,
//   encoded per call on the host: rows past T and columns past D arrive as
//   zeros, so a ragged tail and D = 80 run the same code.
// - Products. S = Q K^T as wgmma m64n64k16 with K K-major in shared memory
//   (5 k-steps at D = 80, 8 at D = 128) and Q as the register A operand,
//   read from its swizzled tile once per item (`smem_to_a`), so a key tile
//   reads only K from shared memory (the form with both operands in shared
//   memory measured slower). P is rounded to bf16 in registers as the A
//   operand of O += P V, wgmma m64n128k16 with V read MN-major from the
//   same tile (at D = 80 the 48 zero columns are computed and not stored).
//   No operand is transposed by hand. Each consumer issues tile i + 1's S
//   before tile i's P V, so the tensor cores run one product while the
//   warpgroup's softmax runs on the other; the two consumers interleave on
//   their own (an explicit ping-pong between them measured no faster).
// - Masks cost as much as the products when every tile takes them, so a
//   tile takes only those it needs: the causal diagonal and the ragged key
//   tail as one column limit per row, and the segment-id compare only when
//   the query half or the key tile holds more than one id, or two
//   different ones (a flag in the tile's list entry, set from the tables).
// - Balance. Under the causal mask the last query block sees the most
//   tiles, so items run in reverse query order, heaviest first, dealt to
//   the blocks in a snake order (block c takes item c of even rounds and
//   item G - 1 - c of odd ones).

#include "hopper.cuh"

#ifndef FLASH_FWD_PERSISTENT
#define FLASH_FWD_PERSISTENT 1  // 0: one block per work item, for comparison
#endif

namespace {

using namespace hopper;

constexpr int TILE = 64;                            // rows of a query half, keys of a K/V tile
constexpr int CONSUMERS = 2;                        // consumer warpgroups, 64 query rows each
constexpr int BLOCK_M = CONSUMERS * TILE;           // query rows of a work item
constexpr int NUM_THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int STAGES = 4;                           // K/V ring depth
constexpr int SLOTS = 2;                            // items whose Q and list are resident
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;  // 128 * 56 + 256 * 224 = 384 * 168 registers
// a list entry is the key tile in its low KT_BITS bits, and bit KT_BITS + w
// when query half w needs the segment-id compare on that tile
constexpr int KT_BITS = 24;
constexpr int KT_MASK = (1 << KT_BITS) - 1;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const int* q_seg;    // (B, Tq) or null
  const int* kv_seg;   // (B, 64 n_kt) or null
  const int4* q_tab;   // (B, n_qt) segment ranges of the query tiles, or null
  const int4* kv_tab;  // (B, n_kt) of the key tiles, or null
  __nv_bfloat16* o;    // (B, H, Tq, D)
  float* lse;          // (B, H, Tq)
  int* walked;         // null, or the sum of every item's live key tiles
  int H, KV, Tq, Tk, D;
  int n_qt, n_kt;      // 64-row tiles; kv_seg rows are padded to 64 n_kt
  int n_qb;            // items per head: blocks of BLOCK_M query rows
  int n_items;         // B * H * n_qb
  float scale_log2;    // sm_scale * log2(e)
  int causal;
};

// One work item: the head slice b * H + h and the query block.
struct Item {
  int bh, qb;
};

// The j-th item of this block, or bh = -1 past the last. Items run in
// rounds of gridDim.x, heaviest query block first under the causal mask,
// and are dealt in a snake order so that no block takes the heaviest item
// of every round.
__device__ __forceinline__ Item item_at(const Params& p, int j) {
  const int G = gridDim.x;
  const int w = j * G + ((j & 1) ? G - 1 - static_cast<int>(blockIdx.x) : blockIdx.x);
  if (w >= p.n_items) return {-1, 0};
  const int BH = p.n_items / p.n_qb;
  const int order = w / BH;
  return {w % BH, p.causal ? p.n_qb - 1 - order : order};
}

// A tile holds a single segment id: its ranges (`tile_segment_ranges`)
// hold one value, on one side only.
__device__ __forceinline__ bool single_id(int4 r, int& id) {
  id = r.x == r.y ? r.x : r.z;
  return (r.x == r.y && r.z > r.w) || (r.z == r.w && r.x > r.y);
}

template <int KSTEPS>
__global__ void __launch_bounds__(NUM_THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem;  // slot i, half w at + (i * CONSUMERS + w) * TILE_BYTES
  unsigned char* sK = sQ + SLOTS * CONSUMERS * TILE_BYTES;  // stage s at + s * TILE_BYTES
  unsigned char* sV = sK + STAGES * TILE_BYTES;             // likewise
  int* kseg = reinterpret_cast<int*>(sV + STAGES * TILE_BYTES);    // [STAGES][TILE]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kseg + STAGES * TILE);  // [SLOTS]
  uint64_t* q_empty = q_full + SLOTS;  // [SLOTS]: every consumer warp is done with the item
  uint64_t* full = q_empty + SLOTS;    // [STAGES]: the stage's K, V and key ids landed
  uint64_t* empty = full + STAGES;     // [STAGES]: every consumer warp is done with it
  int* n_live = reinterpret_cast<int*>(empty + STAGES);  // [SLOTS]
  int* warp_counts = n_live + SLOTS;
  int* lists = warp_counts + 1;  // [SLOTS][n_kt]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool has_seg = p.q_seg != nullptr;

  if (tid == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], CONSUMERS * 4);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // ------------------------------------------------------------ producer
    reg_dealloc<PRODUCER_REGS>();
    if (tid < CONSUMERS * 128 + 32) {  // one warp: the lists, and its lane 0 the loads
      int it = 0;  // K/V tiles issued so far, over all items
      for (int j = 0;; ++j) {
        const Item item = item_at(p, j);
        if (item.bh < 0) break;
        const int b = item.bh / p.H;
        const int bk = b * p.KV + (item.bh % p.H) / (p.H / p.KV);
        const int qt0 = item.qb * CONSUMERS;
        const int qt_last = min(qt0 + CONSUMERS - 1, p.n_qt - 1);
        const int slot = j % SLOTS;
        if (j >= SLOTS) mbar_wait(&q_empty[slot], ((j / SLOTS) - 1) & 1);

        // key tiles live for either half: causal keeps tiles <= the
        // half's own, segment ranges keep the overlapping ones. A half
        // skips the segment-id compare on a tile when both hold one and the
        // same id.
        int* list = lists + slot * p.n_kt;
        const int4* q_tab = has_seg ? p.q_tab + b * p.n_qt : nullptr;
        const int4* kv_tab = has_seg ? p.kv_tab + b * p.n_kt : nullptr;
        const int n = build_live_list<32>(
            list, warp_counts, 0, p.causal ? min(qt_last + 1, p.n_kt) : p.n_kt, [&](int kt) {
              if (!has_seg) return kt;
              const int4 kr = kv_tab[kt];
              int kid, qid;
              const bool k_one = single_id(kr, kid);
              bool live = false;
              int entry = kt;
              for (int qt = qt0; qt <= qt_last; ++qt) {
                const int4 qr = q_tab[qt];
                live = live || ((!p.causal || kt <= qt) && ranges_overlap(qr, kr));
                if (!(k_one && single_id(qr, qid) && qid == kid)) {
                  entry |= 1 << (KT_BITS + qt - qt0);
                }
              }
              return live ? entry : -1;
            });
        if (lane == 0) {
          n_live[slot] = n;
          if (p.walked != nullptr) atomicAdd(p.walked, n);
          // the arrive publishes the list; the bytes are Q's
          mbar_arrive_expect_tx(&q_full[slot], CONSUMERS * TILE_BYTES);
          for (int w = 0; w < CONSUMERS; ++w) {
            tma_load_tile(sQ + (slot * CONSUMERS + w) * TILE_BYTES, &tm_q, &q_full[slot],
                          (qt0 + w) * TILE, item.bh);
          }
          const int* seg_row =
              has_seg ? p.kv_seg + static_cast<size_t>(b) * p.n_kt * TILE : nullptr;
          for (int i = 0; i < n; ++i, ++it) {
            const int s = it % STAGES;
            if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
            const int n_start = (list[i] & KT_MASK) * TILE;
            mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES + (has_seg ? TILE * 4 : 0));
            tma_load_tile(sK + s * TILE_BYTES, &tm_k, &full[s], n_start, bk);
            tma_load_tile(sV + s * TILE_BYTES, &tm_v, &full[s], n_start, bk);
            if (has_seg) bulk_load(kseg + s * TILE, seg_row + n_start, TILE * 4, &full[s]);
          }
        }
        __syncwarp();
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<CONSUMER_REGS>();
    const int wg = tid >> 7;  // which 64-row half
    const int warp = (tid & 127) >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = wg * TILE + 16 * warp + g;  // this thread's rows in the item: r0, r0 + 8
    int it = 0;  // K/V tiles consumed so far, over all items
    for (int j = 0;; ++j) {
      const Item item = item_at(p, j);
      if (item.bh < 0) break;
      const int slot = j % SLOTS;
      const int q_lo = item.qb * BLOCK_M + wg * TILE;  // the half's first row
      const int row0 = item.qb * BLOCK_M + r0;
      // this thread's rows' segment ids (rows past Tq are never stored)
      int qs[2] = {0, 0};
      if (has_seg) {
        const int* ids = p.q_seg + static_cast<size_t>(item.bh / p.H) * p.Tq;
        if (row0 < p.Tq) qs[0] = ids[row0];
        if (row0 + 8 < p.Tq) qs[1] = ids[row0 + 8];
      }
      mbar_wait(&q_full[slot], (j / SLOTS) & 1);
      const int n = n_live[slot];
      const int* list = lists + slot * p.n_kt;
      // Q's A operand, k-step kk in qa[kk], kept in registers for the item
      uint32_t qa[KSTEPS][4];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        smem_to_a(qa[kk], sQ + (slot * CONSUMERS + wg) * TILE_BYTES, kk);
      }

      float o[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // running row max, log2 domain
      float l_run[2] = {0.f, 0.f};              // this thread's part of the row sum
      float alpha[2];
      float sc[32];       // S of a tile, then its P
      uint32_t pa[4][4];  // P of the tile in flight, as bf16 A fragments

      // S = Q K^T (64 queries x 64 keys) of the tile in stage s, issued
      auto issue_s = [&](int s) {
        const uint32_t k_addr = smem_u32(sK + s * TILE_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          wgmma_m64n64k16_rs(sc, qa[kk], desc_kmajor(k_addr, kk), kk);
        }
        wgmma_commit();
      };

      // masks and online softmax of list entry i (stage s): P in sc, the
      // row max and sum updated, alpha the factor for O
      auto softmax = [&](int i, int s) {
        const int entry = list[i];
        const int n_start = (entry & KT_MASK) * TILE;
        const bool seg_mask = (entry >> (KT_BITS + wg)) & 1;
        // masks, where the tile needs them: segment ids, the causal
        // diagonal and the keys past Tk (zero-filled by TMA). Element
        // sc[4 j + e] is row row0 + 8 (e / 2), column n_start + 8 j + 2 t +
        // e % 2; lim[r] is the last column row r may see, less n_start + 2 t.
        if (seg_mask || n_start + TILE > p.Tk || (p.causal && n_start + TILE - 1 > q_lo)) {
          int lim[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int last = p.causal ? min(p.Tk - 1, row0 + 8 * r) : p.Tk - 1;
            lim[r] = last - n_start - 2 * t;
          }
          if (seg_mask) {
            const int2* ks = reinterpret_cast<const int2*>(kseg + s * TILE + 2 * t);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int2 id = ks[4 * j];  // keys 8 j + 2 t and 8 j + 2 t + 1
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                if (8 * j + (e & 1) > lim[r] || ((e & 1) ? id.y : id.x) != qs[r]) {
                  sc[4 * j + e] = -INFINITY;
                }
              }
            }
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              if (8 * (e >> 2) + (e & 1) > lim[(e >> 1) & 1]) sc[e] = -INFINITY;
            }
          }
        }
        // the 4 threads of a quad share a row
        float m_use[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * r], sc[4 * c + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[r], mx * p.scale_log2);
          // a row with no valid key so far keeps p = 0 (exp2(-inf - 0))
          m_use[r] = m_new == -INFINITY ? 0.f : m_new;
          alpha[r] = fast_exp2(m_run[r] - m_use[r]);
          m_run[r] = m_new;
          l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e >> 1) & 1;
          sc[e] = fast_exp2(fmaf(sc[e], p.scale_log2, -m_use[r]));
          l_run[r] += sc[e];
        }
      };

      // O += P V of the tile in stage s, P (in pa) rounded to bf16 in
      // registers, V read MN-major
      auto issue_pv = [&](int s) {
        const uint32_t v_addr = smem_u32(sV + s * TILE_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_rs(o, pa[kk], desc_mnmajor(v_addr, kk), 1);
        wgmma_commit();
      };

      // Tile i's O += P V runs on the tensor cores while tile i + 1's S
      // (issued first) lands and its softmax runs; O is rescaled by tile
      // i + 1's alpha once tile i's product is done. The last tile's
      // product runs alone.
      if (n > 0) {
        mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
        issue_s(it % STAGES);
        wgmma_wait<0>();
        fence_operands(sc);
        softmax(0, it % STAGES);
#pragma unroll 1
        for (int i = 0; i + 1 < n; ++i, ++it) {
          const int s = it % STAGES;
          const int s_next = (it + 1) % STAGES;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);
          mbar_wait(&full[s_next], ((it + 1) / STAGES) & 1);
          issue_s(s_next);
          issue_pv(s);
          wgmma_wait<1>();  // S of tile i + 1
          fence_operands(sc);
          softmax(i + 1, s_next);
          wgmma_wait<0>();
          fence_operands(o);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
#pragma unroll
          for (int e = 0; e < 64; ++e) o[e] *= alpha[(e >> 1) & 1];
        }
        const int s = it % STAGES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);
        issue_pv(s);
        wgmma_wait<0>();
        fence_operands(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        ++it;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[slot]);  // and with the item's Q, ids and list

      // full row sums, normalise, store o and the natural-log logsumexp
      const size_t stat_off = static_cast<size_t>(item.bh) * p.Tq;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = l > 0.f ? 1.f / l : 0.f;
        const int row = row0 + 8 * r;
        if (t == 0 && row < p.Tq) {
          p.lse[stat_off + row] = l > 0.f ? (m_run[r] + log2f(l)) * LN2 : -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] *= inv[(e >> 1) & 1];
      store_acc(p.o + stat_off * p.D, o, row0, p.Tq, p.D);
    }
  }
}

// Q's slots, the K/V ring, the ring's key ids, the barriers, the list
// counts, the warp count and the slots' lists
size_t smem_bytes(int n_kt) {
  return 1024 + (SLOTS * CONSUMERS + 2 * STAGES) * TILE_BYTES + STAGES * TILE * sizeof(int) +
         2 * (SLOTS + STAGES) * sizeof(uint64_t) + (SLOTS + 1 + SLOTS * n_kt) * sizeof(int);
}

template <int KSTEPS>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.n_kt);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<KSTEPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // one persistent block per SM
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = FLASH_FWD_PERSISTENT ? min(sms, p.n_items) : p.n_items;
  flash_fwd_kernel<KSTEPS><<<blocks, NUM_THREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
// The wrapper has checked shapes, dtypes, contiguity and alignment, and
// hands the query segment ids as they are and the key segment ids padded
// to a multiple of 64 rows, with the tile tables of both (all four null
// without segment ids). `walked`, when not null, is an int32 on the
// device that gains every item's live key tiles.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, const void* q_seg,
                              const void* kv_seg, const void* q_tab, const void* kv_tab, void* o,
                              void* lse, void* walked, int B, int H, int KV, int Tq, int Tk, int D,
                              float sm_scale, int causal, void* stream) {
  if (D != 80 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.q_tab = static_cast<const int4*>(q_tab);
  p.kv_tab = static_cast<const int4*>(kv_tab);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.walked = static_cast<int*>(walked);
  p.H = H;
  p.KV = KV;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.n_qt = (Tq + TILE - 1) / TILE;
  p.n_kt = (Tk + TILE - 1) / TILE;
  p.n_qb = (Tq + BLOCK_M - 1) / BLOCK_M;
  p.n_items = B * H * p.n_qb;
  p.scale_log2 = sm_scale * LOG2E;
  p.causal = causal;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tile_map(&tq, q, B * H, Tq, D);
  if (err == cudaSuccess) err = tile_map(&tk, k, B * KV, Tk, D);
  if (err == cudaSuccess) err = tile_map(&tv, v, B * KV, Tk, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = D == 80 ? launch<5>(tq, tk, tv, p, s) : launch<8>(tq, tk, tv, p, s);
  return static_cast<int>(err);
}
