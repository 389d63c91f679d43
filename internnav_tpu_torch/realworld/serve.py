"""Real-robot inference server launcher for the PyTorch port.

    python -m internnav_tpu_torch.realworld.serve --port 5801 [--profile realtime|parity]

Builds the InternVLA-N1 policy at the full Qwen2.5-VL-7B width (random
weights from a seeded generator: no checkpoint loading is ported yet),
wraps it in the dual-system agent and serves it through `RealWorldServer`
(`realworld/server.py`: stdlib HTTP, POST /eval_dual and /reset). The
profiles are the JAX launcher's (`scripts/realworld/http_internvla_server.py`):
`realtime` (the default) serves W8A8 decoder projections and an int8 KV
cache, `parity` bf16 weights and a bf16 KV cache; the vision tower and
System-1 are bf16 in both. A native checkpoint's recorded weight dtype
must win over the profile (ROADMAP F4); that waits for checkpoint loading,
which the port does not have yet. `--device cuda` without a GPU raises:
there is no CPU fallback.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

# clients of the port take the server and its payload encoder from here
from internnav_tpu_torch.realworld.server import RealWorldServer, encode_npy  # noqa: F401

#: the JAX launcher's serving profiles: the text model's weight and KV formats
PROFILES = {
    "realtime": {"weight_dtype": "int8", "kv_dtype": "int8"},
    "parity": {"weight_dtype": "bf16", "kv_dtype": "bf16"},
}


def build_policy(profile: str = "realtime", *, device: torch.device):
    """The served policy at Qwen2.5-VL-7B dims, random weights (seed 0),
    in the profile's formats."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}")
    return InternVLAN1Policy.build(InternVLAN1Config.qwen25vl_7b(**PROFILES[profile]),
                                   device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5801)
    ap.add_argument("--profile", default="realtime", choices=sorted(PROFILES))
    ap.add_argument("--device", default="cuda", help="a CUDA device (no CPU fallback)")
    args = ap.parse_args(argv)

    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent

    policy = build_policy(args.profile, device=require_cuda(args.device))
    RealWorldServer(InternVLAN1Agent(policy), args.host, args.port).run()


if __name__ == "__main__":
    main()
