"""Real-robot inference server launcher for the PyTorch port.

    python -m internnav_tpu_torch.realworld.serve --port 5801 \
        [--ckpt checkpoints/InternVLA-N1] [--system1 nextdit_async] [--profile realtime|parity]

Builds the InternVLA-N1 policy at the full Qwen2.5-VL-7B width, wraps it in
the dual-system agent and serves it through `RealWorldServer`
(`realworld/server.py`: stdlib HTTP, POST /eval_dual and /reset). The
profiles are the JAX launcher's (`scripts/realworld/http_internvla_server.py`):
`realtime` (the default) serves W8A8 decoder projections and an int8 KV
cache, `parity` bf16 weights and a bf16 KV cache; the vision tower and
System-1 are bf16 in both. `--ckpt` loads a reference-format checkpoint
(HF layout; quantized on load under `realtime`) or a native directory of
the port (`scripts/torch/convert_checkpoint.py`, `save_pretrained`); a
native directory's recorded weight dtype wins over the profile's, and the
KV cache stays the profile's (ROADMAP F4: the JAX launcher forces the
profile's weight dtype and then refuses a bf16 native checkpoint). Without
`--ckpt` the weights are random, drawn from a seeded generator. The
`nextdit_async` System-1 is the one ported; `navdp*` raises. `--device
cuda` without a GPU raises: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

# clients of the port take the server and its payload encoder from here
from internnav_tpu_torch.realworld.server import RealWorldServer, encode_npy  # noqa: F401

#: the JAX launcher's serving profiles: the text model's weight and KV formats
PROFILES = {
    "realtime": {"weight_dtype": "int8", "kv_dtype": "int8"},
    "parity": {"weight_dtype": "bf16", "kv_dtype": "bf16"},
}


def build_policy(profile: str = "realtime", *, device: torch.device, ckpt: Optional[str] = None,
                 system1: str = "nextdit_async", config=None):
    """The served policy in the profile's formats: at Qwen2.5-VL-7B dims
    (or `config`'s), random weights from seed 0 without `ckpt`, else the
    checkpoint's. A native directory keeps the weight dtype it records
    (F4); an HF-layout checkpoint takes the profile's, quantized on load
    for int8. Prints the weight and KV formats chosen and why."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import (
        InternVLAN1Policy,
        checkpoint_format,
        native_weight_dtype,
    )

    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}")
    fmt = PROFILES[profile]
    weight, why = fmt["weight_dtype"], f"the {profile} profile's"
    kind = checkpoint_format(ckpt) if ckpt else None
    if kind == "native":
        recorded = native_weight_dtype(ckpt)
        if recorded != weight:
            why = f"recorded by the native checkpoint; the {profile} profile asks {weight}"
        else:
            why = "recorded by the native checkpoint"
        weight = recorded
    cfg = config if config is not None else InternVLAN1Config.qwen25vl_7b(system1)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, weight_dtype=weight, kv_dtype=fmt["kv_dtype"]))
    source = {None: "random weights (seed 0)", "native": f"native checkpoint {ckpt}",
              "hf": f"reference-format checkpoint {ckpt}" + (
                  ", quantized on load" if weight == "int8" else "")}[kind]
    print(f"serve: weight_dtype={weight} ({why}), kv_dtype={fmt['kv_dtype']} (the {profile} "
          f"profile's), {source}", flush=True)
    if kind is None:
        return InternVLAN1Policy.build(cfg, device=device)
    if kind == "native":
        return InternVLAN1Policy.from_pretrained(ckpt, cfg, device=device)
    return InternVLAN1Policy.from_pretrained_torch(ckpt, cfg, device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5801)
    ap.add_argument("--ckpt", default="",
                    help="reference-format checkpoint or native directory (random weights "
                         "without it)")
    ap.add_argument("--system1", default="nextdit_async",
                    help="System-1 head: nextdit_async (navdp* is not ported and raises)")
    ap.add_argument("--profile", default="realtime", choices=sorted(PROFILES))
    ap.add_argument("--device", default="cuda", help="a CUDA device (no CPU fallback)")
    args = ap.parse_args(argv)

    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent

    policy = build_policy(args.profile, device=require_cuda(args.device), ckpt=args.ckpt or None,
                          system1=args.system1)
    RealWorldServer(InternVLAN1Agent(policy), args.host, args.port).run()


if __name__ == "__main__":
    main()
