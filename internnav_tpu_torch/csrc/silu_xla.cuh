// jax.nn.silu of a bf16 value as XLA computes it, shared by K6a's SWIGLU
// prologue and K8 (quantize_rows.cu) and K8f's epilogue (swiglu_gemm.cu),
// so that the three keep one copy of the arithmetic (ops/activations.py
// `silu_reference` is its plain version).

#pragma once

#include <cuda_bf16.h>

namespace xla {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16(1 / d) for a bf16 value d >= 1 (or +inf, or NaN), equal to the
// IEEE division rounded to bf16: d has 8 significant bits and a bf16
// rounding midpoint 9 (the last one set), so d times a midpoint is never
// 1 and 1 / d lies at least 2^-17 of itself from every midpoint, while
// rcp.approx is within one fp32 ulp (2^-23). Its flush to zero only takes
// results below 2^-126, which `silu_xla` flushes anyway, and no bf16 d
// has 1 / d in the band just below 2^-126 that rounds up to it.
__device__ __forceinline__ float bf16_reciprocal(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return bf16_round(r);
}

// g * (1 / (1 + exp(-g))) with every step rounded to bf16, and subnormals
// flushed: |g| < 2^-125 gives a signed zero, and so does a sigmoid below
// 2^-126. Accurate expf, the reciprocal as IEEE division would round it
// (`bf16_reciprocal`) and no multiply-add contraction, as ATen runs the
// plain version's ops one kernel each.
__device__ __forceinline__ float silu_xla(float g) {
  g = fabsf(g) >= 0x1p-125f ? g : __fmul_rn(g, 0.0f);
  const float ex = bf16_round(expf(-g));
  const float d = bf16_round(__fadd_rn(ex, 1.0f));
  float s = bf16_reciprocal(d);
  s = s >= 0x1p-126f ? s : 0.0f;
  return bf16_round(__fmul_rn(g, s));
}

}  // namespace xla
