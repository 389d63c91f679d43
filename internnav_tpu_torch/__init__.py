"""internnav_tpu_torch — PyTorch/CUDA port of internnav_tpu for NVIDIA Hopper.

The JAX package `internnav_tpu` stays the reference. This package mirrors its
layout (`ops/`, `model/basemodel/internvla_n1/`, `model/encoder/`, `agent/`,
`realworld/`, `dataset/`, `trainer/`, `configs/`, `env/`, `evaluator/`),
imports torch and never jax nor the JAX package, and carries its
hand-written CUDA kernels under `csrc/` (built on first use, see
`ops/_build.py`).

Ported so far: the InternVLA-N1 single-robot serving path (vision tower,
Qwen2.5 text prefill/decode, traj-latent chunk decode, System-1
`nextdit_async`), its agent and its HTTP launcher, in both serving
profiles: `parity` (bf16) and `realtime` (W8A8 projections and an int8 KV
cache, with their CUDA kernels `csrc/quantize_rows.cu`,
`csrc/w8a8_gemm.cu`, `csrc/rope_kv_write.cu` and `csrc/decode_int8.cu`);
batched multi-cohort serving (`serving.py`: `BatchedN1Policy`, the shared
grouped decode and `PipelinedN1Server`), whose greedy decode loop, like
the single-stream one, replays a captured CUDA graph per step
(`decode_graph.py`); the evaluator path of the headline
(`evaluator.VLNPipelinedEvaluator` over `env.FakeEnv`, driving
`agent.BatchedInternVLAN1Agent` cohorts; `scripts/torch/bench_evaluator.py`
measures it); the N1 finetune path (`trainer.train_n1`) with the
flash-attention backward kernels, grad accumulation, the parameter EMA and
FSDP / tensor-parallel layouts over a DeviceMesh (`parallel/`); and
checkpoint loading (`model/weights/`: HF-layout InternVLA-N1 checkpoints,
quantized on load for `realtime`, and the port's native format); the int4
and W8A16 formats; and the NavDP System-1 (`navdp_async`, `navdp`:
`model/basemodel/internvla_n1/navdp_head.py`), served single-stream,
batched and through the evaluator.
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
