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
// Bound by the cache bytes (one byte per element plus a scale per key).
// B = 1 x 4 KV heads is only four (batch, head) pairs for 132 SMs, so Tmax
// is split into 32-key chunks, one block each (grid: chunks x KV x B). A
// block stages its chunk of K and V in shared memory, scores it for the
// G * n query rows of its KV head (the G = H / KV heads of a group read
// their KV head once), and writes unnormalised partial outputs with their
// own row max and sum. The last block of a (batch, head) to finish (an
// atomic count) weighs each chunk by exp(m_chunk - m) / l, with m and l the
// row's max and sum over all chunks (as the flash forward's lse combines),
// and resets the count. Tmax is at most 128 chunks (4,096 keys).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int kChunk = 32;    // keys per block, one per lane
constexpr int kMaxRows = 32;  // G * n query rows per (batch, KV head)
constexpr int kMaxChunks = 128;  // Tmax <= 4096 keys
constexpr int kThreads = 128;

struct Args {
  const __nv_bfloat16* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const long long* len;
  long long k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long ks_sb, ks_sh, ks_st, vs_sb, vs_sh, vs_st;
  float* o_part;  // (B * KV, chunks, rows, D)
  float2* ml;     // (B * KV, chunks, rows): (max, sum)
  int* counters;  // (B * KV), zero between launches
  __nv_bfloat16* out;
  int H, KV, n, Tmax, chunks, len_offset;
  float sm_scale;
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

__global__ void __launch_bounds__(kThreads) decode_int8_kernel(Args a) {
  __shared__ __align__(16) float qs[kMaxRows][D];
  __shared__ uint32_t kt[kChunk][D / 4 + 1];  // padded rows: lane j reads row j conflict-free
  __shared__ __align__(16) int8_t vt[kChunk][D];
  __shared__ float ps[kMaxRows][kChunk];
  __shared__ float kscale[kChunk], vscale[kChunk];
  __shared__ float weight[kMaxChunks][kMaxRows];  // the combine's exp(m_c - m) / l
  __shared__ int is_last;

  const int chunk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.H / a.KV, R = G * a.n;
  const int bh = b * a.KV + kh;
  const long long len0 = a.len[b] + a.len_offset;  // keys row 0 sees
  const long long t0 = (long long)chunk * kChunk;
  float* opart = a.o_part + ((size_t)bh * a.chunks + chunk) * kMaxRows * D;
  float2* ml = a.ml + ((size_t)bh * a.chunks + chunk) * kMaxRows;

  if (t0 < min(len0 + a.n - 1, (long long)a.Tmax)) {
    // q rows and the chunk's K and V, 16 bytes a load, all of a thread's
    // loads in flight before its stores
    int4 qv[kMaxRows * D / 8 / kThreads], kv[2][kChunk * D / 16 / kThreads];
#pragma unroll
    for (int u = 0; u < kMaxRows * D / 8 / kThreads; ++u) {
      const int idx = tid + u * kThreads, r = idx / (D / 8), d8 = idx % (D / 8);
      if (r < R) {
        const int h = kh * G + r / a.n, i = r % a.n;
        qv[u] = *reinterpret_cast<const int4*>(a.q + (((size_t)b * a.H + h) * a.n + i) * D + 8 * d8);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk * D / 16 / kThreads; ++u) {
      const int idx = tid + u * kThreads, j = idx / (D / 16), w16 = idx % (D / 16);
      const long long t = t0 + j;
      kv[0][u] = kv[1][u] = make_int4(0, 0, 0, 0);
      if (t < a.Tmax) {
        kv[0][u] = *reinterpret_cast<const int4*>(a.k + b * a.k_sb + kh * a.k_sh + t * a.k_st + 16 * w16);
        kv[1][u] = *reinterpret_cast<const int4*>(a.v + b * a.v_sb + kh * a.v_sh + t * a.v_st + 16 * w16);
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxRows * D / 8 / kThreads; ++u) {
      const int idx = tid + u * kThreads, r = idx / (D / 8), d8 = idx % (D / 8);
      if (r < R) {
        const __nv_bfloat16* h8 = reinterpret_cast<const __nv_bfloat16*>(&qv[u]);
#pragma unroll
        for (int e = 0; e < 8; ++e) qs[r][8 * d8 + e] = __bfloat162float(h8[e]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk * D / 16 / kThreads; ++u) {
      const int idx = tid + u * kThreads, j = idx / (D / 16), w16 = idx % (D / 16);
      kt[j][4 * w16] = kv[0][u].x;
      kt[j][4 * w16 + 1] = kv[0][u].y;
      kt[j][4 * w16 + 2] = kv[0][u].z;
      kt[j][4 * w16 + 3] = kv[0][u].w;
      *reinterpret_cast<int4*>(&vt[j][16 * w16]) = kv[1][u];
    }
    if (tid < kChunk) {
      const long long t = t0 + tid;
      const bool in = t < a.Tmax;
      kscale[tid] = in ? a.ks[b * a.ks_sb + kh * a.ks_sh + t * a.ks_st] : 0.f;
      vscale[tid] = in ? a.vs[b * a.vs_sb + kh * a.vs_sh + t * a.vs_st] : 0.f;
    }
    __syncthreads();

    // scores and chunk statistics: lane = key, each warp a quarter of the rows
    const long long t = t0 + lane;
    for (int r = warp; r < R; r += kThreads / 32) {
      float acc = 0.f;
#pragma unroll 8
      for (int w = 0; w < D / 4; ++w) {
        const uint32_t kw = kt[lane][w];
        const float4 qv = *reinterpret_cast<const float4*>(&qs[r][4 * w]);
        acc += qv.x * (float)(int8_t)(kw & 0xff) + qv.y * (float)(int8_t)((kw >> 8) & 0xff) +
               qv.z * (float)(int8_t)((kw >> 16) & 0xff) + qv.w * (float)(int8_t)(kw >> 24);
      }
      const bool valid = t < a.Tmax && t < len0 + r % a.n;
      const float s = valid ? acc * a.sm_scale * kscale[lane] : -INFINITY;
      const float m = warp_max(s);
      const float p = (m == -INFINITY || !valid) ? 0.f : expf(s - m);
      const float l = warp_sum(p);
      ps[r][lane] = p * vscale[lane];
      if (lane == 0) ml[r] = make_float2(m, l);
    }
    __syncthreads();

    // unnormalised P.V: thread = head dim
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
    for (int j = 0; j < kChunk; ++j) {
      const float vv = (float)vt[j][tid];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < R) acc[r] += ps[r][j] * vv;
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < R) opart[r * D + tid] = acc[r];
  } else {  // past every row's keys: an empty chunk
    for (int r = tid; r < R; r += kThreads) ml[r] = make_float2(-INFINITY, 0.f);
  }

  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&a.counters[bh], 1) == a.chunks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // combine the chunks of this (batch, KV head). Each warp takes rows,
  // its lanes the chunks: the row's max and sum, and every chunk's weight
  // exp(m_c - m) / l (0 for a chunk without a key of the row).
  const float2* ml_all = a.ml + (size_t)bh * a.chunks * kMaxRows;
  const float* o_all = a.o_part + (size_t)bh * a.chunks * kMaxRows * D;
  for (int r = warp; r < R; r += kThreads / 32) {
    float m = -INFINITY;
    for (int c = lane; c < a.chunks; c += 32) m = fmaxf(m, __ldcg(&ml_all[c * kMaxRows + r]).x);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < a.chunks; c += 32) {
      const float2 cml = __ldcg(&ml_all[c * kMaxRows + r]);
      const float w = cml.x == -INFINITY ? 0.f : expf(cml.x - m);
      weight[c][r] = w;
      l += cml.y * w;
    }
    const float inv = 1.f / warp_sum(l);
    for (int c = lane; c < a.chunks; c += 32) weight[c][r] *= inv;
  }
  __syncthreads();
  // thread = head dim: the weighted sum of the partial outputs of the
  // chunks that hold a key (all of them written), the loads of all rows
  // of a chunk in flight together
  const int active = (int)min((long long)a.chunks, (len0 + a.n - 1 + kChunk - 1) / kChunk);
  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
  for (int c = 0; c < active; ++c) {
    const float* oc = o_all + (size_t)c * kMaxRows * D + tid;
    float o[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) o[r] = r < R ? __ldcg(oc + r * D) : 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] += o[r] * weight[c][r];
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < R) {
      const int h = kh * G + r / a.n, i = r % a.n;
      a.out[(((size_t)b * a.H + h) * a.n + i) * D + tid] = __float2bfloat16_rn(acc[r]);
    }
  }
  if (tid == 0) a.counters[bh] = 0;
}

}  // namespace

// Strides are in elements; k/v stride along D is 1. len (B,) int64.
// o_part holds B * KV * chunks * 32 * 128 floats, ml B * KV * chunks * 32
// float2; counters B * KV ints, zero on entry (and on exit).
// Returns cudaGetLastError() after the launch.
extern "C" int decode_int8_attention(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* len, void* o_part, void* ml, void* counters, void* out, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long ks_sb, long long ks_sh, long long ks_st, long long vs_sb, long long vs_sh,
    long long vs_st, int B, int H, int KV, int n, int Tmax, int chunks, int len_offset,
    float sm_scale, void* stream) {
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
  a.o_part = static_cast<float*>(o_part);
  a.ml = static_cast<float2*>(ml);
  a.counters = static_cast<int*>(counters);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H, a.KV = KV, a.n = n, a.Tmax = Tmax, a.chunks = chunks, a.len_offset = len_offset;
  a.sm_scale = sm_scale;
  decode_int8_kernel<<<dim3(chunks, KV, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
