"""Real-robot inference server launcher for the PyTorch port.

    python -m internnav_tpu_torch.realworld.serve --port 5801 --profile parity --device cuda

Builds the InternVLA-N1 policy at the full Qwen2.5-VL-7B width (bf16,
random weights from a seeded generator: no checkpoint loading is ported
yet), wraps it in the dual-system agent and serves it through
`RealWorldServer` (`realworld/server.py`: stdlib HTTP, POST /eval_dual and
/reset). Only the `parity` profile (bf16 weights, bf16 KV cache) is ported;
`realtime` (W8A8 + int8 KV) raises. `--device cuda` without a GPU raises:
there is no CPU fallback.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

# clients of the port take the server and its payload encoder from here
from internnav_tpu_torch.realworld.server import RealWorldServer, encode_npy  # noqa: F401

PROFILES = ("parity", "realtime")


def build_policy(profile: str = "parity", *, device: torch.device):
    """The served policy at Qwen2.5-VL-7B dims, random weights (seed 0)."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}")
    if profile != "parity":
        raise NotImplementedError(f"profile {profile!r} (int8 weights / int8 KV) is not yet ported")
    return InternVLAN1Policy.build(InternVLAN1Config.qwen25vl_7b(), device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5801)
    ap.add_argument("--profile", default="parity", choices=PROFILES)
    ap.add_argument("--device", default="cuda", help="a CUDA device (no CPU fallback)")
    args = ap.parse_args(argv)

    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent

    policy = build_policy(args.profile, device=require_cuda(args.device))
    RealWorldServer(InternVLAN1Agent(policy), args.host, args.port).run()


if __name__ == "__main__":
    main()
