"""SiLU with the JAX package's bf16 roundings, and its kernel K8.

`jax.nn.silu(x)` is `x * logistic(x)`. XLA computes the logistic of a bf16
input as `1 / (1 + exp(-x))`, rounds every step to bf16, and then rounds
the product with x. A SwiGLU's product with `up` is rounded once more.
torch's `F.silu` computes the whole SiLU in fp32 and rounds once, so a
bf16 SwiGLU came out one bf16 ulp apart in about a third of its elements
(ROADMAP F14). `silu` and `silu_mul` take XLA's steps on bf16 tensors. On
every other dtype they are `F.silu` and `F.silu(gate) * up`.

XLA also flushes subnormal values to zero, and so does the bf16 `silu`: an
input below 2^-125 in magnitude gives a signed zero (its product with 0.5
would be subnormal), and so does a sigmoid below 2^-126 (inputs at or
below -87.5). That makes `silu` equal to `jax.nn.silu` on every finite
bf16 input. `silu_mul` does not flush the product with `up`, which is
subnormal only where both factors are tiny.

XLA runs those steps as one fusion; in eager torch they are ten kernels
(`silu_reference`), which made the host-bound System-1 denoise and the
train step's SwiGLU markedly slower. So on CUDA the bf16 SiLU is K8
(`silu_bf16` in `csrc/quantize_rows.cu`, the same arithmetic as K6a's
SWIGLU prologue): one launch for `silu` or `silu_mul`, bitwise equal to
the plain version. On the CPU the plain version runs.

K8's output carries no autograd history, so `silu` and `silu_mul` on bf16
tensors that need a gradient go through `torch.autograd.Function`s
(`_SiluBf16`, `_SiluMulBf16`) whose backward is the one torch's autograd
gives `F.silu` in bf16 (ROADMAP F29: `silu` once had none, and System-1's
time embedding trained on no gradient on the card).

`swiglu_gemm` is NextDiT's whole SwiGLU input, silu(x W1^T) * (x W3^T):
on CUDA one launch of K8f (`csrc/swiglu_gemm.cu`, the two products with
the SiLU and the product as their epilogue), on the CPU its plain version
(`swiglu_gemm_reference`). K8f has no backward: the feed-forward takes it
only where no gradient is recorded.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

#: the smallest normal fp32 (and bf16) magnitude, and the largest subnormal
#: bf16 value below it
_TINY = 2.0 ** -126
_MAX_SUBNORMAL = 0x7F * 2.0 ** -133

#: K8's and K8f's launches in this process (each CUDA wrapper adds one per
#: launch)
silu_launches = 0
swiglu_gemm_launches = 0
#: the counters' names (`decode_graph` adds a captured step's launches to
#: them at every replay of its graph)
LAUNCH_COUNTERS = ("silu_launches", "swiglu_gemm_launches")


def silu_reference(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu's roundings on a bf16 tensor: x * (1 / (1 + exp(-x))),
    every op rounded to bf16, subnormals flushed. K8's plain version."""
    x = x * (x.abs() >= 2 * _TINY)  # 0 * x keeps x's sign
    s = F.threshold(torch.reciprocal(torch.exp(-x) + 1), _MAX_SUBNORMAL, 0.0)
    return x * s


def silu_mul_reference(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """`silu_reference(gate) * up`, the product rounded to bf16."""
    return silu_reference(gate) * up


def swiglu_gemm_reference(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """silu(x W1^T) * (x W3^T) with each product rounded to bf16 and XLA's
    SiLU roundings: K8f's plain version."""
    return silu_mul_reference(F.linear(x, w1), F.linear(x, w3))


@functools.lru_cache(maxsize=None)
def _silu_entry():
    """K8's C entry point, built and bound once per process."""
    from internnav_tpu_torch.ops._build import load_library

    fn = load_library("quantize_rows.cu").silu_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def silu_cuda(gate: torch.Tensor, up=None) -> torch.Tensor:
    """K8: silu(gate), or silu(gate) * up, of contiguous bf16 CUDA tensors
    of one shape. Raises on anything else."""
    global silu_launches
    for name, t in (("gate", gate), ("up", up)):
        if t is not None and (not t.is_cuda or t.dtype != torch.bfloat16
                              or not t.is_contiguous() or t.shape != gate.shape
                              or t.device != gate.device):
            raise ValueError(f"SiLU kernel: {name} must be a contiguous bf16 CUDA tensor of "
                             f"gate's shape, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(gate)
    if gate.numel():
        with torch.cuda.device(gate.device.index):
            err = _silu_entry()(gate.data_ptr(), None if up is None else up.data_ptr(),
                                out.data_ptr(), gate.numel(),
                                torch.cuda.current_stream(gate.device.index).cuda_stream)
        if err != 0:
            raise RuntimeError(f"SiLU kernel launch failed: cudaError_t {err}")
        silu_launches += 1
    return out


def _silu_mul_bf16(gate: torch.Tensor, up=None) -> torch.Tensor:
    if gate.is_cuda:
        return silu_cuda(gate.contiguous(), None if up is None else up.contiguous())
    if gate.device.type != "cpu":
        raise ValueError(f"silu has no path for device {gate.device}")
    return silu_reference(gate) if up is None else silu_mul_reference(gate, up)


class _SiluBf16(torch.autograd.Function):
    """silu(x) on bf16 with a gradient: the forward is K8 (or the plain
    version on the CPU), the backward the one torch's autograd gives
    `F.silu(x)` in bf16."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _silu_mul_bf16(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.silu_backward(grad, x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu's roundings on bf16 (K8 on CUDA, `silu_reference` on
    the CPU; differentiable through `_SiluBf16` where x needs a gradient);
    F.silu on any other dtype."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _SiluBf16.apply(x)
    return _silu_mul_bf16(x)


class _SiluMulBf16(torch.autograd.Function):
    """silu(gate) * up on bf16 that keeps only gate and up for its
    backward. Its gradients are those torch's autograd gives
    `F.silu(gate) * up` in bf16, with silu(gate) as XLA rounds it."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return _silu_mul_bf16(gate, up)

    @staticmethod
    def backward(ctx, grad):
        gate, up = ctx.saved_tensors
        d_gate = torch.ops.aten.silu_backward(grad * up, gate)
        return d_gate, grad * _silu_mul_bf16(gate)


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The SwiGLU product silu(gate) * up: on bf16 with XLA's roundings
    (`silu`, then the product rounded; K8 on CUDA), elsewhere
    F.silu(gate) * up."""
    if gate.dtype != torch.bfloat16:
        return F.silu(gate) * up
    if torch.is_grad_enabled() and (gate.requires_grad or up.requires_grad):
        return _SiluMulBf16.apply(gate, up)
    return _silu_mul_bf16(gate, up)


# ------------------------------------------------------------------- K8f
@functools.lru_cache(maxsize=None)
def _swiglu_gemm_entry():
    """K8f's C entry point, built and bound once per process."""
    from internnav_tpu_torch.ops._build import load_library

    fn = load_library("swiglu_gemm.cu").swiglu_gemm_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def swiglu_gemm_cuda(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """K8f: silu(x W1^T) * (x W3^T) of x (M, K) and w1, w3 (N, K), all
    contiguous, 16-byte aligned bf16 CUDA tensors on one device, K a
    multiple of 8; (M, N) bf16 out. Raises on anything else, and where a
    gradient would be recorded (K8f has no backward)."""
    global swiglu_gemm_launches
    for name, t in (("x", x), ("w1", w1), ("w3", w3)):
        if (not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous()
                or t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"SwiGLU GEMM kernel: {name} must be a contiguous, 16-byte aligned "
                             f"2-D bf16 CUDA tensor on x's device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    (M, K), N = x.shape, w1.shape[0]
    if w1.shape != (N, K) or w3.shape != (N, K) or K < 8 or K % 8:
        raise ValueError(f"SwiGLU GEMM kernel: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w3 "
                         f"{tuple(w3.shape)}: want (M, K) and two (N, K), K a multiple of 8")
    if torch.is_grad_enabled() and (x.requires_grad or w1.requires_grad or w3.requires_grad):
        raise RuntimeError("SwiGLU GEMM kernel has no backward: call it where no gradient is "
                           "recorded (torch.no_grad), or use silu_mul of the two products")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M:
        with torch.cuda.device(x.device.index):
            err = _swiglu_gemm_entry()(x.data_ptr(), w1.data_ptr(), w3.data_ptr(),
                                       out.data_ptr(), M, N, K,
                                       torch.cuda.current_stream(x.device.index).cuda_stream)
        if err != 0:
            raise RuntimeError(f"SwiGLU GEMM kernel launch failed: cudaError_t {err}")
        swiglu_gemm_launches += 1
    return out


def swiglu_gemm(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """The SwiGLU input silu(x W1^T) * (x W3^T) of x (..., K) and w1, w3
    (N, K), (..., N) out: on bf16 with XLA's roundings (K8f on CUDA,
    `swiglu_gemm_reference` on the CPU). K8f has no backward: where x is
    not bf16, or a gradient would be recorded, it is `silu_mul` of the two
    products (on bf16 K8 under `_SiluMulBf16`)."""
    if x.dtype != torch.bfloat16 or (torch.is_grad_enabled() and (
            x.requires_grad or w1.requires_grad or w3.requires_grad)):
        return silu_mul(F.linear(x, w1), F.linear(x, w3))
    if x.is_cuda:
        lead, K = x.shape[:-1], x.shape[-1]
        out = swiglu_gemm_cuda(x.reshape(-1, K).contiguous(), w1.contiguous(), w3.contiguous())
        return out.reshape(*lead, w1.shape[0])
    if x.device.type != "cpu":
        raise ValueError(f"swiglu_gemm has no path for device {x.device}")
    return swiglu_gemm_reference(x, w1, w3)
