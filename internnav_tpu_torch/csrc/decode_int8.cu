// K4/K5: grouped-query decode attention over the int8 KV cache, CUDA C++
// for sm_90a.
//
// Replaces the XLA int8 branch of internnav_tpu/ops/flash_attention.py
// `gqa_decode_attention` (:548-586, K4, n = 1) and
// `gqa_chunk_decode_attention` (:589-626, K5, the n = n_query traj-latent
// chunk). One kernel serves both: query row i of a (batch, KV head) sees
// keys t < len[b] + len_offset + i (decode: len = cache_len + 1, offset 0;
// chunk: len = cache_len, offset 1: stepwise causal). Per key:
//   s = (q . k_int8) * sm_scale * k_scale[t]   (fp32)
//   p = softmax_t(s) * v_scale[t]
//   o = sum_t p * v_int8                       (bf16 out)
// The scales multiply logits and probabilities, so the int8 cache is never
// dequantized into a copy.
//
// Layout: q (B, H, n, D) bf16 contiguous; the caches are read in place
// through strides as (B, KV, Tmax, D) int8 views of the (B, Tmax, KV, D)
// cache, the scales as (B, KV, Tmax) fp32 views; D = 128.
//
// Bound by the cache bytes (one byte per element plus a scale per key),
// and at one token a step by latency: B = 1 x 4 KV heads is four (batch,
// head) pairs for 132 SMs. Design:
// - One thread-block cluster of S blocks per (batch, KV head), grid
//   (S, KV, B); S (at most 16, the non-portable cluster size) is chosen
//   from Tmax by the wrapper (`decode_cluster_size`). Block s walks keys
//   [s L / S, (s + 1) L / S) of the live range [0, L), L = min(Tmax,
//   len + offset + n - 1): no block touches a key past the last row's.
// - A block walks its keys in 128-key tiles; cp.async stages K, V (16
//   bytes a copy, XOR-swizzled) and their scales two tiles ahead. The
//   G * n query rows of the KV head (the G = H / KV heads of a group read
//   their KV head once) are taken in row tiles of 16, so G * n has no cap.
// - Products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   accumulate; int8 and bf16 hold the same integers, q is bf16): each of
//   the 8 warps owns 16 keys of every tile, scores them (S = Q K^T), keeps
//   its own online softmax per row, and adds P V into its 16 x 128 output.
//   The order of the keys inside a warp's 16 is chosen so that every
//   fragment is one 32-bit shared-memory load: key pairs of the score
//   tiles are neighbours in a transposed copy of V (d-major, each warp
//   transposing its own keys with byte permutes), and the head dims of q
//   and K are permuted alike inside each 16 (a dot product does not
//   depend on the order).
//   int8 is widened without I2F: a byte permute and an fp32 add. Warps
//   whose keys lie past the block's range skip the tile.
// - The 8 warps' (max, sum, output) merge in shared memory into the
//   block's partial (each row's warp weights computed once). Combine
//   across the cluster: after a cluster barrier each row's weights
//   exp(m_s - m) / l (as the flash forward's lse combines) are computed
//   once, and the R x D outputs are split across the S blocks (4 threads
//   an output), each reading its peers' partials through distributed
//   shared memory. A second cluster barrier keeps
//   every block's shared memory alive until its peers have read it. No
//   global scratch, no atomics.

#include <cooperative_groups.h>
#include <math.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = 16;                 // keys a warp owns in every tile
constexpr int kTile = kWarps * kWarpKeys;     // keys per tile
constexpr int kRows = 16;                     // query rows per row tile (the mma's M)
constexpr int kStages = 2;                    // tiles in flight
constexpr int kMaxCluster = 16;               // the non-portable cluster size
constexpr int kVtStride = kTile + 16;  // bytes a transposed V row: conflict-free fragment loads
constexpr int kQStride = D + 8;        // bf16 a q row

struct Args {
  const __nv_bfloat16* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const long long* len;
  long long k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long ks_sb, ks_sh, ks_st, vs_sb, vs_sh, vs_st;
  __nv_bfloat16* out;
  int H, KV, n, Tmax, S, len_offset;
  float sm_scale;
};

struct Smem {
  // 16-byte chunk c of key j at chunk c ^ (j & 7) of the key's 128 bytes
  int8_t k[kStages][kTile * D];
  int8_t v[kStages][kTile * D];
  float ks[kStages][kTile], vs[kStages][kTile];
  int8_t vt[D * kVtStride];  // the tile's V, d-major: vt[d][key]
  __nv_bfloat16 q[kRows * kQStride];
  // the warps' results of the row tile, merged into the block's
  float ow[kWarps][kRows][D];
  float mw[kWarps][kRows], lw[kWarps][kRows], fw[kWarps][kRows];
  // the block's partial result of the row tile, read by its peers
  float o[kRows][D];
  float m[kRows], l[kRows];
  float wt[kRows][kMaxCluster];  // the combine's weight of each block's partial
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// `bytes` (4 or 16) from global to shared memory, zero-filled when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four int8 (a 32-bit word) as two bf16 pairs, exactly: byte b + 128 becomes
// the low mantissa byte of 2^23 (a byte permute), an fp32 add removes
// 2^23 + 128, and the integer (|x| <= 128) is exact in bf16
__device__ __forceinline__ void int8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t biased = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    f[b] = __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | b)) - 8388736.f;
  }
  lo = hopper::pack_bf16(f[0], f[1]);
  hi = hopper::pack_bf16(f[2], f[3]);
}

// d (16 x 8 fp32) += A (16 x 16 bf16) B (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): A row g and
// g + 8, k 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3); B column g, the
// same k; C rows g, g + 8, columns 2t, 2t + 1. Inside each 16 of the head
// dims, logical k 2t + i sits at d 4t + i and 2t + 8 + i at 4t + 2 + i, in q
// and in K alike. Inside warp w's 16 keys, column c of score tile h is key
// 16 w + 4 (c / 2) + 2 h + c % 2, so the keys of P's k 2t, 2t + 1, 2t + 8,
// 2t + 9 are 16 w + 4t + 0..3: one word of the transposed V.

__global__ void __launch_bounds__(kThreads, 1) decode_int8_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int S = a.S;
  const int rank = static_cast<int>(cluster.block_rank());
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = a.H / a.KV, R = G * a.n;
  const long long len0 = a.len[b] + a.len_offset;  // keys row 0 sees
  const long long live = max(0LL, min(static_cast<long long>(a.Tmax), len0 + a.n - 1));
  const long long k_begin = rank * live / S, k_end = (rank + 1) * live / S;
  const int tiles = static_cast<int>((k_end - k_begin + kTile - 1) / kTile);
  const int8_t* kbase = a.k + b * a.k_sb + kh * a.k_sh;
  const int8_t* vbase = a.v + b * a.v_sb + kh * a.v_sh;
  const float* ksbase = a.ks + b * a.ks_sb + kh * a.ks_sh;
  const float* vsbase = a.vs + b * a.vs_sb + kh * a.vs_sh;

  // tile i of this block's keys into stage st: 16-byte copies of K and V
  // (8 consecutive threads read one key's 128 bytes), and the scales;
  // keys past the block's range are zero-filled
  auto load_tile = [&](int i, int st) {
    const long long t0 = k_begin + static_cast<long long>(i) * kTile;
    for (int idx = tid; idx < kTile * D / 16; idx += kThreads) {
      const int j = idx >> 3, c = idx & 7;
      const long long tk = t0 + j;
      const bool in = tk < k_end;
      const long long tt = in ? tk : k_begin;
      const int dst = j * D + ((c ^ (j & 7)) << 4);
      cp_async<16>(&sm.k[st][dst], kbase + tt * a.k_st + 16 * c, in);
      cp_async<16>(&sm.v[st][dst], vbase + tt * a.v_st + 16 * c, in);
    }
    {
      const int j = tid & (kTile - 1);
      const long long tk = t0 + j;
      const bool in = tk < k_end;
      const long long tt = in ? tk : k_begin;
      if (tid < kTile) {
        cp_async<4>(&sm.ks[st][j], ksbase + tt * a.ks_st, in);
      } else {
        cp_async<4>(&sm.vs[st][j], vsbase + tt * a.vs_st, in);
      }
    }
  };

  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int rows = min(kRows, R - r0);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s < tiles) load_tile(s, s);
      cp_async_commit();
    }
    // the row tile's queries, bf16, zero past `rows`: row r is head
    // kh * G + (r0 + r) / n, query (r0 + r) % n
    for (int idx = tid; idx < kRows * (D / 8); idx += kThreads) {
      const int r = idx / (D / 8), d8 = idx % (D / 8);
      int4 raw = make_int4(0, 0, 0, 0);
      if (r < rows) {
        const int h = kh * G + (r0 + r) / a.n, i = (r0 + r) % a.n;
        raw = *reinterpret_cast<const int4*>(
            a.q + ((static_cast<size_t>(b) * a.H + h) * a.n + i) * D + 8 * d8);
      }
      *reinterpret_cast<int4*>(&sm.q[r * kQStride + 8 * d8]) = raw;
    }
    __syncthreads();
    // q's A fragments for the 8 k-steps: rows g, g + 8 at d 16 kk + 4t .. + 3
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint2 lo = *reinterpret_cast<const uint2*>(&sm.q[g * kQStride + 16 * kk + 4 * t]);
      const uint2 hi =
          *reinterpret_cast<const uint2*>(&sm.q[(g + 8) * kQStride + 16 * kk + 4 * t]);
      qa[kk][0] = lo.x;
      qa[kk][1] = hi.x;
      qa[kk][2] = lo.y;
      qa[kk][3] = hi.y;
    }
    // the rows' query index (the causal offset of the chunk) and validity
    int qi[2];
    bool row_ok[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = g + 8 * rr;
      row_ok[rr] = r < rows;
      qi[rr] = (r0 + r) % a.n;
    }

    float o[D / 8][4];  // this warp's P V: rows g, g + 8 x head dims 8 nd + 2t, + 1
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
    }
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
    float l_run[2] = {0.f, 0.f};              // this thread's part of the row sums

    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      const long long t0 = k_begin + static_cast<long long>(it) * kTile;
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const int valid = static_cast<int>(min(static_cast<long long>(kTile), k_end - t0));

      // this warp's 16 keys; a warp past the block's range skips the tile
      if (kWarpKeys * warp < valid) {
        // its keys' V transposed into vt[d][key], 4 keys x 4 head dims a
        // step (four words in, four out; lane = key quad x head-dim quad)
#pragma unroll
        for (int step = 0; step < D / 32; ++step) {
          const int k4 = (kWarpKeys / 4) * warp + (lane & 3), d4 = (lane >> 2) + 8 * step;
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * k4 + e;
            w[e] = *reinterpret_cast<const uint32_t*>(
                &sm.v[st][j * D + (((d4 >> 2) ^ (j & 7)) << 4) + 4 * (d4 & 3)]);
          }
          const uint32_t t01 = __byte_perm(w[0], w[1], 0x5140);
          const uint32_t t23 = __byte_perm(w[2], w[3], 0x5140);
          const uint32_t u01 = __byte_perm(w[0], w[1], 0x7362);
          const uint32_t u23 = __byte_perm(w[2], w[3], 0x7362);
          int8_t* dst = &sm.vt[(4 * d4) * kVtStride + 4 * k4];
          *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t01, t23, 0x5410);
          *reinterpret_cast<uint32_t*>(dst + kVtStride) = __byte_perm(t01, t23, 0x7632);
          *reinterpret_cast<uint32_t*>(dst + 2 * kVtStride) = __byte_perm(u01, u23, 0x5410);
          *reinterpret_cast<uint32_t*>(dst + 3 * kVtStride) = __byte_perm(u01, u23, 0x7632);
        }
        __syncwarp();
        // S = Q K^T: score tiles h = 0, 1 (8 keys each)
        float s[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[h][e] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = kWarpKeys * warp + 4 * (g >> 1) + 2 * h + (g & 1);  // column g's key
          const int8_t* krow = sm.k[st] + j * D;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t kw =
                *reinterpret_cast<const uint32_t*>(krow + ((kk ^ (j & 7)) << 4) + 4 * t);
            uint32_t b0, b1;
            int8x4_to_bf16x2(kw, b0, b1);
            mma_bf16(s[h], qa[kk], b0, b1);
          }
        }
        // scales and masks: element e of tile h is row g + 8 (e / 2), key
        // 16 w + 4t + 2h + e % 2
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = kWarpKeys * warp + 4 * t + 2 * h + (e & 1);
            const int rr = e >> 1;
            const long long tk = t0 + j;
            const bool ok = row_ok[rr] && j < valid && tk < len0 + qi[rr];
            s[h][e] = ok ? s[h][e] * a.sm_scale * sm.ks[st][j] : -INFINITY;
            mx[rr] = fmaxf(mx[rr], s[h][e]);
          }
        }
        // this warp's online softmax: the 4 threads of a quad share a row
        float alpha[2], m_use[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          const float m_new = fmaxf(m_run[rr], mx[rr]);
          // a row with no valid key so far keeps p = 0 and its sum 0
          m_use[rr] = m_new == -INFINITY ? 0.f : m_new;
          alpha[rr] = expf(m_run[rr] - m_use[rr]);
          m_run[rr] = m_new;
          l_run[rr] *= alpha[rr];
        }
        uint32_t pa[4];  // P (times v_scale) as the A fragment of P V
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const int j = kWarpKeys * warp + 4 * t + 2 * h + (e & 1);
            p[e] = expf(s[h][e] - m_use[rr]);
            l_run[rr] += p[e];
            p[e] *= sm.vs[st][j];
          }
          pa[2 * h] = hopper::pack_bf16(p[0], p[1]);      // row g: k 2t, 2t + 1 (+ 8 h)
          pa[2 * h + 1] = hopper::pack_bf16(p[2], p[3]);  // row g + 8
        }
        // O = alpha O + P V: B fragment of head-dim tile nd is the word
        // vt[8 nd + g][16 w + 4t]
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          o[nd][0] *= alpha[0];
          o[nd][1] *= alpha[0];
          o[nd][2] *= alpha[1];
          o[nd][3] *= alpha[1];
          const uint32_t vw = *reinterpret_cast<const uint32_t*>(
              &sm.vt[(8 * nd + g) * kVtStride + kWarpKeys * warp + 4 * t]);
          uint32_t b0, b1;
          int8x4_to_bf16x2(vw, b0, b1);
          mma_bf16(o[nd], pa, b0, b1);
        }
      }
      __syncthreads();  // stage st and vt are free
      if (it + kStages < tiles) load_tile(it + kStages, st);
      cp_async_commit();
    }
    cp_async_wait<0>();

    // merge the warps: each leaves its rows' max, sum and output
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_run[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (t == 0) {
        sm.mw[warp][g + 8 * rr] = m_run[rr];
        sm.lw[warp][g + 8 * rr] = l;
      }
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<float2*>(&sm.ow[warp][g][8 * nd + 2 * t]) = make_float2(o[nd][0], o[nd][1]);
      *reinterpret_cast<float2*>(&sm.ow[warp][g + 8][8 * nd + 2 * t]) =
          make_float2(o[nd][2], o[nd][3]);
    }
    __syncthreads();
    // the block's partial (an empty block or warp leaves max -inf, sum 0):
    // each row's warp weights exp(m_w - m) once, then thread = head dim x
    // half of the rows
    if (tid < kRows) {
      const int r = tid;
      float mb = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm.mw[w][r]);
      float lb = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sm.mw[w][r];
        const float f = mw == -INFINITY ? 0.f : expf(mw - mb);
        sm.fw[w][r] = f;
        lb = fmaf(sm.lw[w][r], f, lb);
      }
      sm.m[r] = mb;
      sm.l[r] = lb;
    }
    __syncthreads();
    {
      const int d = tid % D;
      for (int r = tid / D; r < rows; r += kThreads / D) {
        float ob = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) ob = fmaf(sm.ow[w][r][d], sm.fw[w][r], ob);
        sm.o[r][d] = ob;
      }
    }
    cluster.sync();

    // combine: each row's weight of every block's partial, exp(m_s - m) /
    // l (0 for a block without a key of the row), once per row: warp =
    // rows, lane s = block s, read through distributed shared memory
    for (int r = warp; r < rows; r += kWarps) {
      float ms = -INFINITY, ls = 0.f;
      if (lane < S) {
        const Smem* peer = cluster.map_shared_rank(&sm, lane);
        ms = peer->m[r];
        ls = peer->l[r];
      }
      const float mx = warp_max(ms);
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      const float l = warp_sum(ls * w);
      if (lane < S) sm.wt[r][lane] = l > 0.f ? w / l : 0.f;
    }
    __syncthreads();
    // the rows x D outputs split across the S blocks, each the weighted
    // sum of the S partials: 4 neighbouring threads an output, each
    // reading every 4th block's partial, summed by shuffles
    const int total = rows * D, per = (total + S - 1) / S;
    const int e_end = min(total, (rank + 1) * per);
    constexpr int kSplit = 4;
    for (int base = rank * per; base < e_end; base += kThreads / kSplit) {
      const int e = base + tid / kSplit, part = tid % kSplit;
      const bool live_e = e < e_end;
      const int r = live_e ? e / D : 0, dd = e % D;
      float os[kMaxCluster / kSplit];
#pragma unroll
      for (int q = 0; q < kMaxCluster / kSplit; ++q) {
        const int s = part + kSplit * q;
        os[q] = live_e && s < S ? cluster.map_shared_rank(&sm, s)->o[r][dd] : 0.f;
      }
      float o_sum = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster / kSplit; ++q) {
        const int s = part + kSplit * q;
        if (s < S) o_sum = fmaf(os[q], sm.wt[r][s], o_sum);
      }
      o_sum += __shfl_xor_sync(0xffffffffu, o_sum, 1);
      o_sum += __shfl_xor_sync(0xffffffffu, o_sum, 2);
      if (live_e && part == 0) {
        const int h = kh * G + (r0 + r) / a.n, i = (r0 + r) % a.n;
        a.out[((static_cast<size_t>(b) * a.H + h) * a.n + i) * D + dd] =
            __float2bfloat16_rn(o_sum);
      }
    }
    cluster.sync();  // the peers have read this block's partials
  }
}

}  // namespace

// Strides are in elements; k/v stride along D is 1. len (B,) int64. S is
// the cluster size (1..16), grid (S, KV, B). Returns a cudaError_t (0 =
// launched).
extern "C" int decode_int8_attention(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* len, void* out, long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long ks_sb, long long ks_sh, long long ks_st,
    long long vs_sb, long long vs_sh, long long vs_st, int B, int H, int KV, int n, int Tmax,
    int S, int len_offset, float sm_scale, void* stream) {
  if (S < 1 || S > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.len = static_cast<const long long*>(len);
  a.k_sb = k_sb, a.k_sh = k_sh, a.k_st = k_st, a.v_sb = v_sb, a.v_sh = v_sh, a.v_st = v_st;
  a.ks_sb = ks_sb, a.ks_sh = ks_sh, a.ks_st = ks_st;
  a.vs_sb = vs_sb, a.vs_sh = vs_sh, a.vs_st = vs_st;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H, a.KV = KV, a.n = n, a.Tmax = Tmax, a.S = S, a.len_offset = len_offset;
  a.sm_scale = sm_scale;

  // the attributes are set once per device
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(decode_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(Smem)));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(decode_int8_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_int8_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
