// K7: rotary + int8 KV quantization + cache write in one launch, for the
// int8 KV cache of the `realtime` profile; CUDA C++ for sm_90a.
//
// Replaces the XLA code of internnav_tpu/model/basemodel/internvla_n1/
// qwen_text.py that runs between the q/k/v projections and the decode
// attention: `apply_rotary` (:375-387) on q and k, `quantize_kv` (:527-537)
// on k and v, and the cache writes `_write_cache` / `_write_cache_chunk`
// (:556-583). Per token and head row of D = 32 V elements:
//   rotary (q and k rows, ROTARY): c, s = bf16(cos), bf16(sin);
//     x' = bf16(bf16(x * c) + bf16(rotate_half(x) * s))   (the port's bf16
//     `apply_rotary`, rounding where torch's bf16 ops round)
//   q rows: stored to q_rot (B, H, n, D), the layout K4/K5 read;
//   k and v rows: scale = max(amax / 127, 1e-8) (the clamp after the
//     division), codes = clip(rint(x' / scale), -127, 127), stored at the
//     cache slot of `cache_write_slots` (ops/quant.py): a chunk, and the
//     token of a one-row batch, start at min(cache_len, Tmax - n); the
//     token of a row of a larger batch (DROP) goes to slot cache_len, and
//     is dropped at or past Tmax.
// Without ROTARY the kernel quantizes and writes k and v as they are (the
// prompt's entries, whose rotated bf16 K the prefill attention reads).
// Every multiply and add rounds on its own (__fmul_rn / __fadd_rn), and the
// divisions are IEEE, so q_rot, the codes and the scales equal the plain
// version bit for bit.
//
// Bound by bytes (q, k, v and the rotary tables read once, q_rot and the
// codes and scales written once; ~16 KB a decode token), and at one token a
// step by latency: the Triton kernel this replaces ran after ~12 eager
// rotary ops and a copy of k. Design: one warp per 128-wide head row (4
// values a lane, 8-byte loads), so a token is H + 2 KV = 36 warps, one
// wave; the rotate-half partner of lane l is lane l ^ 16, one shuffle; the
// amax is a warp shuffle; no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // head rows a block

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Args {
  const __nv_bfloat16 *q, *k, *v;  // (B n, H D), (B n, KV D), (B n, KV D)
  const float *cos, *sin;          // (B, n, D)
  __nv_bfloat16* q_out;            // (B, H, n, D)
  int8_t *kd, *vd;                 // (B, Tmax, KV, D)
  float *ks, *vs;                  // (B, Tmax, KV)
  const void* len;                 // (B,) int32 or int64
  int len64, n, H, KV, Tmax;
};

// V values of a row at lane * V: 2, 4 or 8 bf16 (4, 8 or 16 bytes)
template <int V>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&x)[V]) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(p);
  __nv_bfloat162 t[V / 2];
  if constexpr (V == 2) {
    *reinterpret_cast<uint32_t*>(t) = *reinterpret_cast<const uint32_t*>(h);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(t) = *reinterpret_cast<const uint2*>(h);
  } else {
    *reinterpret_cast<uint4*>(t) = *reinterpret_cast<const uint4*>(h);
  }
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 f = __bfloat1622float2(t[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 2) {
    const float2 f = *reinterpret_cast<const float2*>(p + i);
    x[i] = f.x;
    x[i + 1] = f.y;
  }
}

template <int V, bool ROTARY, bool DROP>
__global__ void __launch_bounds__(kWarps * 32) rope_kv_write_kernel(Args a) {
  constexpr int D = 32 * V;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int qrows = ROTARY ? a.H : 0;
  if (row >= qrows + 2 * a.KV) return;  // a whole warp: the shuffles below stay full
  const long long tok = blockIdx.x;      // b * n + i
  const int b = static_cast<int>(tok / a.n), i = static_cast<int>(tok % a.n);
  const bool is_q = row < qrows;
  const bool is_k = !is_q && row < qrows + a.KV;
  const int h = is_q ? row : (row - qrows) % a.KV;
  const __nv_bfloat16* src = is_q ? a.q + (tok * a.H + h) * D
                                  : (is_k ? a.k : a.v) + (tok * a.KV + h) * D;
  float x[V];
  load_row<V>(src + lane * V, x);

  if (ROTARY && (is_q || is_k)) {
    float c[V], s[V];
    load_f32<V>(a.cos + tok * D + lane * V, c);
    load_f32<V>(a.sin + tok * D + lane * V, s);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      // rotate_half: element d < D/2 takes -x[d + D/2], d >= D/2 takes x[d - D/2]
      const float partner = __shfl_xor_sync(0xffffffffu, x[e], 16);
      const float rh = lane < 16 ? -partner : partner;
      x[e] = bf16_round(__fadd_rn(bf16_round(__fmul_rn(x[e], bf16_round(c[e]))),
                                  bf16_round(__fmul_rn(rh, bf16_round(s[e])))));
    }
  }

  if (is_q) {
    __nv_bfloat162 out[V / 2];
#pragma unroll
    for (int e = 0; e < V / 2; ++e) out[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    __nv_bfloat16* dst = a.q_out + ((static_cast<long long>(b) * a.H + h) * a.n + i) * D + lane * V;
    if constexpr (V == 2) {
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<uint32_t*>(out);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<uint2*>(out);
    } else {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(out);
    }
    return;
  }

  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);

  const long long pos = a.len64 ? static_cast<const long long*>(a.len)[b]
                                : static_cast<long long>(static_cast<const int*>(a.len)[b]);
  long long slot;
  if (DROP) {
    if (pos >= a.Tmax) return;  // a dropped row keeps the slot's old value
    slot = pos;
  } else {
    slot = min(max(pos, 0LL), static_cast<long long>(a.Tmax - a.n)) + i;
  }
  const long long dst_row = (static_cast<long long>(b) * a.Tmax + slot) * a.KV + h;
  uint32_t packed[(V + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(x[e], scale)), -127.f), 127.f);
    packed[e / 4] |= (static_cast<uint32_t>(static_cast<int>(c)) & 0xffu) << (8 * (e % 4));
  }
  int8_t* dst = (is_k ? a.kd : a.vd) + dst_row * D + lane * V;
  if constexpr (V == 2) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(packed[0]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(dst) = packed[0];
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  }
  if (lane == 0) (is_k ? a.ks : a.vs)[dst_row] = scale;
}

template <int V>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const bool rotary = a.q != nullptr;
  const bool drop = a.n == 1 && B > 1;
  const dim3 grid(B * a.n, ((rotary ? a.H : 0) + 2 * a.KV + kWarps - 1) / kWarps);
  if (rotary) {
    if (drop)
      rope_kv_write_kernel<V, true, true><<<grid, kWarps * 32, 0, stream>>>(a);
    else
      rope_kv_write_kernel<V, true, false><<<grid, kWarps * 32, 0, stream>>>(a);
  } else {
    if (drop)
      rope_kv_write_kernel<V, false, true><<<grid, kWarps * 32, 0, stream>>>(a);
    else
      rope_kv_write_kernel<V, false, false><<<grid, kWarps * 32, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// q, cos, sin, q_out: null for a write without rotary. k, v bf16 (B n, KV D);
// q bf16 (B n, H D); cos, sin fp32 (B, n, D); q_out bf16 (B, H, n, D); the
// caches int8 (B, Tmax, KV, D) and fp32 (B, Tmax, KV, 1); len (B,) int64
// (len_is_int64) or int32. D is 64, 128 or 256; every row 2 V-byte aligned.
extern "C" int rope_kv_write(const void* q, const void* k, const void* v, const void* cos,
                             const void* sin, void* q_out, void* k_data, void* k_scale,
                             void* v_data, void* v_scale, const void* len, int len_is_int64,
                             int B, int n, int H, int KV, int D, int Tmax, void* stream) {
  if (B < 1 || n < 1 || n > Tmax || KV < 1 || (q && H < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.q_out = static_cast<__nv_bfloat16*>(q_out);
  a.kd = static_cast<int8_t*>(k_data);
  a.vd = static_cast<int8_t*>(v_data);
  a.ks = static_cast<float*>(k_scale);
  a.vs = static_cast<float*>(v_scale);
  a.len = len;
  a.len64 = len_is_int64, a.n = n, a.H = H, a.KV = KV, a.Tmax = Tmax;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch<2>(a, B, s));
    case 128:
      return static_cast<int>(launch<4>(a, B, s));
    case 256:
      return static_cast<int>(launch<8>(a, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
