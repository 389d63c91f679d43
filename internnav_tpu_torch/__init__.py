"""internnav_tpu_torch — PyTorch/CUDA port of internnav_tpu for NVIDIA Hopper.

The JAX package `internnav_tpu` stays the reference. This package mirrors its
layout (`ops/`, `model/basemodel/internvla_n1/`, `model/encoder/`, `agent/`,
`realworld/`), imports torch and never jax, and carries its hand-written
CUDA kernels under `csrc/` (built on first use, see `ops/_build.py`).

Ported so far: the InternVLA-N1 single-robot serving path in bf16 (vision
tower, Qwen2.5 text prefill/decode, traj-latent chunk decode, System-1
`nextdit_async`), its agent and its HTTP launcher.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def require_cuda(device=None) -> torch.device:
    """The CUDA device to run on; raises when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("internnav_tpu_torch: no CUDA device is available")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError(f"require_cuda: {dev} is not a CUDA device")
    return dev
