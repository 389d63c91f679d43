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

#: K8's launches in this process (its CUDA wrapper adds one per launch)
silu_launches = 0
#: the counters' names (`decode_graph` adds a captured step's launches to
#: them at every replay of its graph)
LAUNCH_COUNTERS = ("silu_launches",)


def silu_reference(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu's roundings on a bf16 tensor: x * (1 / (1 + exp(-x))),
    every op rounded to bf16, subnormals flushed. K8's plain version."""
    x = x * (x.abs() >= 2 * _TINY)  # 0 * x keeps x's sign
    s = F.threshold(torch.reciprocal(torch.exp(-x) + 1), _MAX_SUBNORMAL, 0.0)
    return x * s


def silu_mul_reference(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """`silu_reference(gate) * up`, the product rounded to bf16."""
    return silu_reference(gate) * up


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


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu's roundings on bf16 (K8 on CUDA, `silu_reference` on
    the CPU); F.silu on any other dtype."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
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
