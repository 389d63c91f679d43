// K6a: the per-token int8 activation quantization of the W8A8 `realtime`
// profile, fused into the op that makes its input; CUDA C++ for sm_90a.
// The file also holds K8 (`silu_bf16`, below), the bf16 SiLU of the other
// paths with the same `silu_xla` arithmetic as K6a's SWIGLU prologue.
//
// Replaces the XLA activation quantization of internnav_tpu/model/basemodel/
// internvla_n1/qwen_text.py `QuantDense.__call__` (:173-176):
//   a_scale = max(amax, 1e-8) / 127,   q = clip(rint(y / a_scale), -127, 127)
// over each row y of a projection's input, together with the op before it.
// One kernel, three prologues (template parameter PRO):
// - RMSNORM (q/k/v and gate/up inputs): y = bf16(x * rsqrt(mean(x^2) + eps))
//   * w, the port's `RMSNorm` (qwen_text.py) with its fp32 scale w and fp32
//   product. With a residual h the row is first x' = bf16(x + h), stored,
//   and normalized: the decoder layer's `x = x + h` before the
//   post-attention norm.
// - SWIGLU (down input): y = silu(gate) * up in fp32, with silu(gate) as
//   XLA rounds it on bf16 (`silu_xla`: four bf16 roundings). XLA fuses the
//   product into the quantization's fp32 convert and does not round it to
//   bf16 (`ops/quant.swiglu_quantize_reference`).
// - PLAIN (o_proj and lm_head inputs): y is the bf16 or fp32 row itself.
// The arithmetic is ATen's op for op, so that the codes match the plain
// versions (ops/quant.py): the fp32 sum of squares times fl(1/K) (ATen's
// CUDA `mean`), + eps, `rsqrtf`, `expf` in `silu_xla`, IEEE divisions
// (the build has no fast-math flag), round-to-nearest-even bf16 casts, and
// no multiply-add contraction where ATen rounds between two kernels. SWIGLU
// and PLAIN are bitwise; RMSNORM adds its squares in another order than
// ATen's reduction, which can move the norm's last bit: codes within +-1.
//
// Bound by bytes: each input element read once, one int8 code per element
// (and x' with a residual) and one fp32 scale per row written. A decode row
// (M <= 16) is a few KB, so there the time is latency: the Triton kernel
// this replaces walked a row in 2 * ceil(K / 1024) dependent loads after ~9
// eager ops had written it to device memory. Design: one block of up to
// 1,024 threads per row, the whole row in registers (16-byte vector loads,
// at most kMaxVectors a thread: K <= 40,960 bf16 or 20,480 fp32), every
// load issued before the first use. A row is one load round, one block
// reduction of the squares (RMSNORM) and one of the amax (warp shuffles and
// one shared-memory step each), and one store round. At the prompt (M =
// 1,088-4,864 rows) one block a row fills the 132 SMs and bytes set the time.

#include <algorithm>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Prologue : int { kPlain = 0, kRmsNorm = 1, kSwiGlu = 2 };
constexpr int kMaxThreads = 1024;
constexpr int kMaxVectors = 5;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// jax.nn.silu of a bf16 value as XLA computes it (ops/activations.py
// `silu`): g * (1 / (1 + exp(-g))) with every step rounded to bf16, and
// subnormals flushed: |g| < 2^-125 gives a signed zero, and so does a
// sigmoid below 2^-126.
__device__ __forceinline__ float silu_xla(float g) {
  g = fabsf(g) >= 0x1p-125f ? g : __fmul_rn(g, 0.0f);
  const float ex = bf16_round(expf(-g));
  const float d = bf16_round(__fadd_rn(ex, 1.0f));
  float s = bf16_round(__fdiv_rn(1.0f, d));
  s = s >= 0x1p-126f ? s : 0.0f;
  return bf16_round(__fmul_rn(g, s));
}

// 16 bytes of input as floats: 8 bf16 or 4 fp32
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint4 narrow_bf16(const float (&f)[8]) {
  uint4 u;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// the sum (MAX = false) or the max of v over the block, in every thread;
// red holds 32 floats of shared memory
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

// One block per row of K elements; vector i = threadIdx.x + j * blockDim.x
// (j < NV) of E elements. a: x (RMSNORM), gate (SWIGLU) or the row (PLAIN);
// b: the residual (RMSNORM with RES) or up (SWIGLU); w: the fp32 norm scale.
// The row stays packed in registers (4 a vector: the bf16 row, x + h, or
// silu(gate)); RMSNORM's and SWIGLU's fp32 products are recomputed from it
// in the code pass rather than held (8 registers a vector). SWIGLU takes
// its amax in the first pass, while up is in registers, and reads up again
// (from L1) in the code pass, so up's registers are free after the first
// pass, as in the other prologues.
template <int PRO, typename T, bool RES, int NV>
__global__ void __launch_bounds__(kMaxThreads)
    quantize_rows_kernel(const T* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                         const float* __restrict__ w, float eps, int8_t* __restrict__ q,
                         float* __restrict__ scale, __nv_bfloat16* __restrict__ xsum, int K) {
  constexpr int E = 16 / sizeof(T);
  constexpr bool kTwoInputs = PRO == kSwiGlu || (PRO == kRmsNorm && RES);
  __shared__ float red[32];
  const int nvec = K / E;
  const long long base = static_cast<long long>(blockIdx.x) * K;
  const auto* av = reinterpret_cast<const uint4*>(a + base);
  const auto* bv = reinterpret_cast<const uint4*>(b + base);
  const auto* wv = reinterpret_cast<const uint4*>(w);

  // one load round: every vector of the row (and of its second input and
  // the norm scale) in flight before any is used
  uint4 ra[NV], rb[NV], rw[NV][2];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      ra[j] = av[i];
      if constexpr (kTwoInputs) rb[j] = bv[i];
      if constexpr (PRO == kRmsNorm) {
        rw[j][0] = wv[2 * i];
        rw[j][1] = wv[2 * i + 1];
      }
    }
  }

  float r = 0.f;     // RMSNORM: rsqrt(mean(x^2) + eps)
  float amax = 0.f;  // SWIGLU: taken in the first pass
  if constexpr (PRO == kSwiGlu || PRO == kRmsNorm) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (threadIdx.x + j * blockDim.x >= nvec) continue;
      float x[E];
      widen(ra[j], x);
      if constexpr (kTwoInputs) {
        float y[E];
        widen(rb[j], y);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if constexpr (PRO == kSwiGlu) {
            x[e] = silu_xla(x[e]);  // a bf16 value: narrow_bf16 keeps it exactly
            amax = fmaxf(amax, fabsf(__fmul_rn(x[e], y[e])));
          } else {
            x[e] = __fadd_rn(x[e], y[e]);
          }
        }
        ra[j] = narrow_bf16(x);
        if constexpr (PRO == kRmsNorm)
          reinterpret_cast<uint4*>(xsum + base)[threadIdx.x + j * blockDim.x] = ra[j];
      }
      if constexpr (PRO == kRmsNorm) {
        widen(ra[j], x);
#pragma unroll
        for (int e = 0; e < E; ++e) ss += x[e] * x[e];  // exact: bf16 squared fits fp32
      }
    }
    if constexpr (PRO == kRmsNorm) {
      const float var = __fmul_rn(block_reduce<false>(ss, red), 1.0f / static_cast<float>(K));
      r = rsqrtf(__fadd_rn(var, eps));
    }
  }

  // y: the row as quantized (RMSNORM: bf16(x * r) * w in fp32; SWIGLU:
  // silu(gate) * up in fp32, up read again)
  auto row = [&](int j, float (&y)[E]) {
    widen(ra[j], y);
    if constexpr (PRO == kSwiGlu) {
      float u[E];
      widen(bv[threadIdx.x + j * blockDim.x], u);
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = __fmul_rn(y[e], u[e]);
    }
    if constexpr (PRO == kRmsNorm) {
      float w0[4], w1[4];
      widen(rw[j][0], w0);
      widen(rw[j][1], w1);
#pragma unroll
      for (int e = 0; e < E; ++e)
        y[e] = __fmul_rn(bf16_round(__fmul_rn(y[e], r)), e < 4 ? w0[e] : w1[e - 4]);
    }
  };

  if constexpr (PRO != kSwiGlu) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (threadIdx.x + j * blockDim.x >= nvec) continue;
      float y[E];
      row(j, y);
#pragma unroll
      for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(y[e]));
    }
  }
  const float a_scale = __fdiv_rn(fmaxf(block_reduce<true>(amax, red), 1e-8f), 127.0f);

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i >= nvec) continue;
    float y[E];
    row(j, y);
    uint32_t packed[E / 4];  // E codes, little-endian
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float c = fminf(fmaxf(rintf(__fdiv_rn(y[e + t], a_scale)), -127.f), 127.f);
        word |= (static_cast<uint32_t>(static_cast<int>(c)) & 0xffu) << (8 * t);
      }
      packed[e / 4] = word;
    }
    if constexpr (E == 8) {
      reinterpret_cast<uint2*>(q + base)[i] = make_uint2(packed[0], packed[1]);
    } else {
      reinterpret_cast<uint32_t*>(q + base)[i] = packed[0];
    }
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = a_scale;
}

template <int PRO, typename T, bool RES>
cudaError_t launch(const void* a, const void* b, const void* w, float eps, void* q, void* scale,
                   void* xsum, int M, int K, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = K / E;
  const int nv = (nvec + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
  // the kernel for nv vectors a thread (the row's size decides at run time)
  const decltype(&quantize_rows_kernel<PRO, T, RES, 1>) kernels[kMaxVectors] = {
      quantize_rows_kernel<PRO, T, RES, 1>, quantize_rows_kernel<PRO, T, RES, 2>,
      quantize_rows_kernel<PRO, T, RES, 3>, quantize_rows_kernel<PRO, T, RES, 4>,
      quantize_rows_kernel<PRO, T, RES, 5>};
  if (nv < 1 || nv > kMaxVectors) return cudaErrorInvalidValue;
  kernels[nv - 1]<<<M, threads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const __nv_bfloat16*>(b), static_cast<const float*>(w),
      eps, static_cast<int8_t*>(q), static_cast<float*>(scale), static_cast<__nv_bfloat16*>(xsum),
      K);
  return cudaGetLastError();
}

// K8: silu(gate), or silu(gate) * up, of bf16 tensors with XLA's roundings
// (`silu_xla`, then the product rounded to bf16), n elements. Replaces the
// XLA fusion of `nn.silu(gate) * up` (internnav_tpu/model/basemodel/
// internvla_n1/qwen_text.py:597, qwen_vision.py:199, nextdit.py:146) and of
// `nn.silu(t)` (nextdit.py:81,169,234), which eager torch would run as ten
// elementwise kernels (`ops/activations.silu_reference`). Bound by bytes:
// each input read once, the output written once. Grid-stride over 16-byte
// vectors of 8 elements when every pointer is 16-byte aligned (the first
// threads then take the n % 8 tail), else one element a thread.
template <bool kUp, bool kVec>
__global__ void __launch_bounds__(256)
    silu_bf16_kernel(const __nv_bfloat16* __restrict__ gate, const __nv_bfloat16* __restrict__ up,
                     __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long scalar_from = 0;
  if constexpr (kVec) {
    const long long nvec = n / 8;
    for (long long i = first; i < nvec; i += stride) {
      float g[8];
      widen(reinterpret_cast<const uint4*>(gate)[i], g);
      if constexpr (kUp) {
        float u[8];
        widen(reinterpret_cast<const uint4*>(up)[i], u);
#pragma unroll
        for (int e = 0; e < 8; ++e) g[e] = __fmul_rn(silu_xla(g[e]), u[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) g[e] = silu_xla(g[e]);
      }
      reinterpret_cast<uint4*>(out)[i] = narrow_bf16(g);
    }
    scalar_from = nvec * 8;
  }
  for (long long i = scalar_from + first; i < n; i += stride) {
    float y = silu_xla(__bfloat162float(gate[i]));
    if constexpr (kUp) y = __fmul_rn(y, __bfloat162float(up[i]));
    out[i] = __float2bfloat16_rn(y);
  }
}

template <bool kUp>
cudaError_t launch_silu(const void* gate, const void* up, void* out, long long n,
                        cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(gate) | reinterpret_cast<uintptr_t>(up) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long work = vec ? (n + 7) / 8 : n;
  const int blocks = static_cast<int>(std::min<long long>((work + 255) / 256, 132 * 16));
  const auto* g = static_cast<const __nv_bfloat16*>(gate);
  const auto* u = static_cast<const __nv_bfloat16*>(up);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (vec)
    silu_bf16_kernel<kUp, true><<<blocks, 256, 0, stream>>>(g, u, o, n);
  else
    silu_bf16_kernel<kUp, false><<<blocks, 256, 0, stream>>>(g, u, o, n);
  return cudaGetLastError();
}

}  // namespace

// K8: out = silu(gate) * up (up non-null) or silu(gate), n bf16 elements
// each, contiguous.
extern "C" int silu_bf16(const void* gate, const void* up, void* out, long long n,
                         void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(up ? launch_silu<true>(gate, up, out, n, s)
                             : launch_silu<false>(gate, up, out, n, s));
}

// prologue: 0 PLAIN, 1 RMSNORM, 2 SWIGLU. a: (M, K) bf16, or fp32 for PLAIN
// with fp32_input; b: the residual (RMSNORM, or null) or up (SWIGLU), bf16
// (M, K); weight: fp32 (K,) (RMSNORM); q int8 (M, K), scale fp32 (M,); xsum
// bf16 (M, K), written when RMSNORM has a residual. Every pointer 16-byte
// aligned, K a multiple of 8 (4 for fp32), at most 5 vectors a thread.
extern "C" int quantize_rows(int prologue, int fp32_input, const void* a, const void* b,
                             const void* weight, float eps, void* q, void* scale, void* xsum,
                             int M, int K, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int E = fp32_input ? 4 : 8;
  if (M < 1 || K < E || K % E || (K / E + kMaxThreads - 1) / kMaxThreads > kMaxVectors)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fp32_input) {
    if (prologue != kPlain) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch<kPlain, float, false>(a, b, weight, eps, q, scale, xsum, M, K, s));
  }
  switch (prologue) {
    case kPlain:
      return static_cast<int>(
          launch<kPlain, __nv_bfloat16, false>(a, b, weight, eps, q, scale, xsum, M, K, s));
    case kRmsNorm:
      if (b)
        return static_cast<int>(
            launch<kRmsNorm, __nv_bfloat16, true>(a, b, weight, eps, q, scale, xsum, M, K, s));
      return static_cast<int>(
          launch<kRmsNorm, __nv_bfloat16, false>(a, b, weight, eps, q, scale, xsum, M, K, s));
    case kSwiGlu:
      return static_cast<int>(
          launch<kSwiGlu, __nv_bfloat16, false>(a, b, weight, eps, q, scale, xsum, M, K, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
