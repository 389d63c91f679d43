"""Real-robot inference server launcher for the PyTorch port.

    python -m internnav_tpu_torch.realworld.serve --port 5801 \
        [--ckpt checkpoints/InternVLA-N1] [--system1 nextdit_async|navdp_async|navdp] \
        [--profile realtime|parity]

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
`--ckpt` the weights are random, drawn from a seeded generator.
`--system1` picks the System-1 head: `nextdit_async` (the default),
`navdp_async` (the embedded NavDP head, fp32, on the request's rgb and
depth; a NavDP policy loads only from a native directory, since the
reference-format converter maps no NavDP head) or `navdp` (NavDP on the
latents alone). `--device cuda` without a GPU raises: there is no CPU
fallback; `--device cpu` runs on the host only when asked for.
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
                 system1: Optional[str] = None, config=None,
                 weight_dtype: Optional[str] = None, kv_dtype: Optional[str] = None,
                 tp_group=None):
    """The served policy in the profile's formats: at Qwen2.5-VL-7B dims
    (or `config`'s), random weights from seed 0 without `ckpt`, else the
    checkpoint's; `system1` stands in for the config's System-1 head
    where given (`nextdit_async` at 7B by default). `weight_dtype` ("bf16", "int8" or "int4") and `kv_dtype`
    ("bf16" or "int8") stand in for the profile's where given (the JAX
    agent's `settings['weight_dtype']`, bench.py's `--weight-dtype` /
    `--kv-dtype`). A native directory keeps the weight dtype it records
    (F4); an HF-layout checkpoint takes the asked one, quantized on load
    for int8 and int4. W8A16 / W4A16 decode comes with `config`
    (`decode_act_dtype="bf16"`), as the JAX package selects it. With
    `tp_group` (a mesh's tp group) the checkpoint's decoder is laid out for
    serving over it (`parallel/tp.apply_serve_tp`), each rank reading its
    blocks from the memory-mapped files. Prints the weight and KV formats
    chosen and why."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import (
        InternVLAN1Policy,
        checkpoint_format,
        native_weight_dtype,
    )

    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}")
    fmt = dict(PROFILES[profile])
    weight, why = fmt["weight_dtype"], f"the {profile} profile's"
    if weight_dtype is not None:
        weight, why = weight_dtype, "asked for"
    kv = fmt["kv_dtype"] if kv_dtype is None else kv_dtype
    kv_why = f"the {profile} profile's" if kv_dtype is None else "asked for"
    kind = checkpoint_format(ckpt) if ckpt else None
    if kind == "native":
        recorded = native_weight_dtype(ckpt)
        if recorded != weight:
            why = f"recorded by the native checkpoint; the {profile} profile asks {weight}"
        else:
            why = "recorded by the native checkpoint"
        weight = recorded
    cfg = config if config is not None else InternVLAN1Config.qwen25vl_7b()
    cfg = dataclasses.replace(cfg, system1=system1 or cfg.system1, text=dataclasses.replace(
        cfg.text, weight_dtype=weight, kv_dtype=kv))
    source = {None: "random weights (seed 0)", "native": f"native checkpoint {ckpt}",
              "hf": f"reference-format checkpoint {ckpt}" + (
                  ", quantized on load" if weight in ("int8", "int4") else "")}[kind]
    print(f"serve: system1={cfg.system1}, weight_dtype={weight} ({why}), kv_dtype={kv} "
          f"({kv_why}), decode_act_dtype={cfg.text.decode_act_dtype}, {source}", flush=True)
    if kind is None:
        if tp_group is not None:
            raise ValueError("serving over a tp group loads each rank's blocks from a "
                             "checkpoint: pass ckpt")
        return InternVLAN1Policy.build(cfg, device=device)
    load = (InternVLAN1Policy.from_pretrained if kind == "native"
            else InternVLAN1Policy.from_pretrained_torch)
    return load(ckpt, cfg, device=device, tp_group=tp_group)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5801)
    ap.add_argument("--ckpt", default="",
                    help="reference-format checkpoint or native directory (random weights "
                         "without it)")
    ap.add_argument("--system1", default="nextdit_async",
                    choices=("nextdit_async", "navdp_async", "navdp"),
                    help="System-1 head: nextdit_async (NextDiT on the latents and the memory "
                         "frames), navdp_async (the NavDP head on the latents and an RGBD "
                         "[memory, current] pair: send depth) or navdp (NavDP on the latents)")
    ap.add_argument("--profile", default="realtime", choices=sorted(PROFILES))
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (no CPU fallback), or cpu when asked for")
    args = ap.parse_args(argv)

    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent

    device = torch.device("cpu") if args.device == "cpu" else require_cuda(args.device)
    policy = build_policy(args.profile, device=device, ckpt=args.ckpt or None,
                          system1=args.system1)
    RealWorldServer(InternVLAN1Agent.with_policy(policy), args.host, args.port).run()


if __name__ == "__main__":
    main()
