// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state.
//
// Replaces the TPU Pallas kernel internnav_tpu/ops/flash_attention.py
// `_flash_kernel` (launched by `_flash_forward`). Same function: online-
// softmax attention with an fp32 accumulator, optional causal mask
// (top-left, col <= row, Tq == Tk), optional segment mask
// (q_seg[row] == kv_seg[col]), rows with no valid key give 0, and the
// per-row logsumexp (natural log, -inf for fully masked rows) for a
// backward pass.
//
// Design (a first, simple kernel; not a block-by-block transcription):
// - one thread block of 4 warps per (q tile of 64 rows, head, batch); the
//   TPU's sequential KV grid axis is the loop inside the block, and the
//   whole-tile causal skip ends that loop at the diagonal;
// - grouped-query attention reads KV head h / (H / KV) in place, so the
//   caller never materializes the repeated K/V;
// - ragged lengths are masked (zero-filled tiles + col < Tk), so any T runs
//   here: no power-of-two block rule and no fallback;
// - Q K^T and P V run on the tensor cores through mma.sync m16n8k16 (bf16
//   operands, fp32 accumulate); the S accumulator fragment is re-packed in
//   registers as the A operand of P V (P rounds to bf16 there, as on the
//   TPU); softmax statistics live in registers in the log2 domain.
//
// What bounds it on an H100: text prefill at T ~ 2k is tensor-core bound
// (about 4*T^2*D*H flops against 3*T*D*H*2 bytes), and this kernel reaches
// the tensor cores only through mma.sync with synchronous tile loads, so it
// is far from the wgmma/TMA rate; the segment-masked vision calls compute
// every (q tile, kv tile) pair although only the diagonal window tiles hold
// valid keys, so most of that work is wasted. Skipping tiles by segment
// range, cp.async/TMA double buffering and wgmma are later optimisations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;      // query rows per block: 4 warps x 16 rows
constexpr int BLOCK_N = 64;      // keys per inner iteration
constexpr int NUM_THREADS = 128;
constexpr int PAD = 8;           // bf16 elements of padding per smem row

struct Params {
  const __nv_bfloat16* q;        // (B, H, Tq, D)
  const __nv_bfloat16* k;        // (B, KV, Tk, D)
  const __nv_bfloat16* v;        // (B, KV, Tk, D)
  const int* q_seg;              // (B, Tq) or null
  const int* kv_seg;             // (B, Tk) or null
  __nv_bfloat16* o;              // (B, H, Tq, D)
  float* lse;                    // (B, H, Tq)
  int H, KV, Tq, Tk;
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

template <int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_fwd_kernel(const Params p) {
  constexpr int LDS = D + PAD;
  constexpr int KSTEPS = D / 16;        // k-steps of Q K^T over the head dim
  constexpr int DTILES = D / 8;         // n-tiles of P V over the head dim
  constexpr int NTILES = BLOCK_N / 8;   // n-tiles of Q K^T over the keys

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BLOCK_M * LDS;
  __nv_bfloat16* sV = sK + BLOCK_N * LDS;
  int* sSeg = reinterpret_cast<int*>(sV + BLOCK_N * LDS);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in group
  const int q_start = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const bool has_seg = p.q_seg != nullptr;

  const __nv_bfloat16* qg = p.q + static_cast<size_t>(b * p.H + h) * p.Tq * D;
  const __nv_bfloat16* kg = p.k + static_cast<size_t>(b * p.KV + kvh) * p.Tk * D;
  const __nv_bfloat16* vg = p.v + static_cast<size_t>(b * p.KV + kvh) * p.Tk * D;

  load_tile<D>(sQ, qg, q_start, BLOCK_M, p.Tq);
  __syncthreads();

  // this warp's 16 query rows as A fragments, kept in registers
  const int m0 = warp * 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* base = sQ + (m0 + g) * LDS + kk * 16 + tig * 2;
    qa[kk][0] = ld32(base);
    qa[kk][1] = ld32(base + 8 * LDS);
    qa[kk][2] = ld32(base + 8);
    qa[kk][3] = ld32(base + 8 * LDS + 8);
  }

  // each thread owns two rows of the warp's tile: g and g + 8
  const int row[2] = {q_start + m0 + g, q_start + m0 + g + 8};
  int seg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      seg[r] = row[r] < p.Tq ? p.q_seg[static_cast<size_t>(b) * p.Tq + row[r]] : 0;
    }
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[DTILES][4];
#pragma unroll
  for (int n = 0; n < DTILES; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  const int n_end = p.causal ? min(p.Tk, q_start + BLOCK_M) : p.Tk;
  for (int n_start = 0; n_start < n_end; n_start += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kg, n_start, BLOCK_N, p.Tk);
    load_tile<D>(sV, vg, n_start, BLOCK_N, p.Tk);
    if (has_seg) {
      for (int i = threadIdx.x; i < BLOCK_N; i += NUM_THREADS) {
        const int col = n_start + i;
        sSeg[i] = col < p.Tk ? p.kv_seg[static_cast<size_t>(b) * p.Tk + col] : 0;
      }
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys
    float s[NTILES][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* kb = sK + (j * 8 + g) * LDS + kk * 16 + tig * 2;
        const uint32_t bfrag[2] = {ld32(kb), ld32(kb + 8)};
        mma16816(s[j], qa[kk], bfrag);
      }
    }

    // scale into the log2 domain and mask
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = j * 8 + tig * 2 + (e & 1);
        const int col = n_start + c;
        bool ok = col < p.Tk;
        if (p.causal) ok = ok && col <= row[r];
        if (has_seg) ok = ok && sSeg[c] == seg[r];
        s[j][e] = ok ? s[j][e] * p.scale_log2 : -INFINITY;
      }
    }

    // online softmax update; the 4 threads of a group share a row
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NTILES; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      // a row with no valid key so far keeps p = 0 (exp2(-inf - 0))
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int n = 0; n < DTILES; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[j][e] - m_use[e >> 1]);
        s[j][e] = pe;
        l_run[e >> 1] += pe;
      }
    }

    // O += P V: two S n-tiles form one A fragment over 16 keys
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const __nv_bfloat16* vb = sV + (kk * 16 + tig * 2) * LDS + g;
#pragma unroll
      for (int n = 0; n < DTILES; ++n) {
        const __nv_bfloat16* vn = vb + n * 8;
        const uint32_t bfrag[2] = {pack2(vn[0], vn[LDS]), pack2(vn[8 * LDS], vn[9 * LDS])};
        mma16816(acc[n], pa, bfrag);
      }
    }
  }

  // finalize: full row sums, normalize, store o and the logsumexp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[r] >= p.Tq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = p.o + (static_cast<size_t>(b * p.H + h) * p.Tq + row[r]) * D;
#pragma unroll
    for (int n = 0; n < DTILES; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tig * 2) =
          pack_f32(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    if (tig == 0) {
      p.lse[static_cast<size_t>(b * p.H + h) * p.Tq + row[r]] =
          l > 0.f ? (m_run[r] + log2f(l)) * 0.6931471805599453f : -INFINITY;
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BLOCK_M + 2 * BLOCK_N) * (D + PAD) * sizeof(__nv_bfloat16) +
                      BLOCK_N * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BLOCK_M - 1) / BLOCK_M, p.H, B);
  flash_fwd_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
// The wrapper has checked shapes, dtypes, contiguity and alignment.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* q_seg, const void* kv_seg,
                              void* o, void* lse,
                              int B, int H, int KV, int Tq, int Tk, int D,
                              float sm_scale, int causal, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.KV = KV;
  p.Tq = Tq;
  p.Tk = Tk;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80:
      return static_cast<int>(launch<80>(p, B, s));
    case 128:
      return static_cast<int>(launch<128>(p, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
