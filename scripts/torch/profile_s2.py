#!/usr/bin/env python3
"""Device time by op category of the batched System-2 / System-1 serving calls on the GPU.

Port of scripts/tools/profile_s2.py. Runs `BatchedN1Policy` at the
Qwen2.5-VL-7B width (`--layers` decoder layers, 28 by default) in the
realtime format (W8A8 projections quantized on the card from random bf16
weights by the deployment quantizer, the int8 KV cache), `--batch` streams
(16) of 224x224 frames with saturated 8-frame histories, the full 20-token
decode budget (the stop id pinned to -7) and 32 System-1 samples. It warms
up (one System-2 call and two System-1 calls), prints the best of 3
untraced timings of each, then runs one phase under torch.profiler: `s2`
(one System-2 call), `s1` (one System-1 call) or `cycle` (one System-2
call and two System-1 calls on its latents), the profiler tracing the
device alone. The trace is saved as a chrome trace under `--logdir`; its
device kernels, copies and sets are summed by category (JAX's
`_category`, extended with the port's kernel names: K1 and K4/K5
attention-kernel, cuBLAS / K6b / K9 / K10 matmul/conv, K7 cache-write,
K6a and K8 fusion) and by name (`--top`).

    python scripts/torch/profile_s2.py [--phase s2|s1|cycle] [--batch 16] [--layers 28]
    python scripts/torch/profile_s2.py --parse-only [--logdir DIR]   # re-read a saved trace

Needs the card (raises without CUDA), except `--parse-only`.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

DECODE_TOKENS = 20
IMAGE_HW = 224
NUM_SAMPLE_TRAJS = 32
INSTRUCTION = ("walk down the hallway past the kitchen then turn left "
               "and stop next to the round table")
TRACE = "trace.json"
#: the trace events that are device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: names JAX's rules leave in "other": the port's kernels (K4/K5, K7, K6a,
#: K8; K6b / K9 / K10 are in namespace qgemm) and the CUDA libraries' and
#: PyTorch's, by a piece of their lower-cased name, first match wins
PORT_CATEGORIES = (
    ("decode_int8_kernel", "attention-kernel"),
    ("rope_kv_write_kernel", "cache-write"),
    ("quantize_rows_kernel", "fusion"),
    ("silu_bf16_kernel", "fusion"),
    ("qgemm::", "matmul/conv"),
    ("gemm", "matmul/conv"),
    ("nvjet", "matmul/conv"),
    ("cutlass", "matmul/conv"),
    ("xmma", "matmul/conv"),
    ("memcpy", "copy/convert/transpose"),
    ("index", "scatter/gather"),
    ("softmax", "softmax"),
    ("elementwise", "elementwise"),
    ("reduce_kernel", "reduction"),
    ("norm", "reduction"),
)


def _category(name: str) -> str:
    """JAX's `_category` (scripts/tools/profile_s2.py:78-94) on any name;
    where it says "other", the port's rules (`PORT_CATEGORIES`)."""
    n = name.lower()
    if "flash" in n or "attention" in n or "decode_attention" in n:
        return "attention-kernel"
    if re.search(r"convert|copy|transpose|bitcast", n) and "fusion" not in n:
        return "copy/convert/transpose"
    if "dot" in n or "conv" in n:
        return "matmul/conv"
    if "dynamic-update-slice" in n:
        return "cache-write"
    if "scatter" in n or "gather" in n:
        return "scatter/gather"
    if "fusion" in n:
        return "fusion"
    if "all-reduce" in n or "collective" in n:
        return "collective"
    for piece, cat in PORT_CATEGORIES:
        if piece in n:
            return cat
    return "other"


def parse_trace(log_dir: str, top: int = 40) -> dict:
    """Sum the saved trace's device events by category and by name; print
    both tables. Returns {"total_ms", "categories": {cat: ms}, "top":
    [(ms, name)]}."""
    path = os.path.join(log_dir, TRACE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    per_op: dict = collections.defaultdict(float)
    per_cat: dict = collections.defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        ms = float(ev.get("dur", 0.0)) / 1e3  # the trace's durations are in us
        per_op[ev["name"]] += ms
        per_cat[_category(ev["name"])] += ms
    total = sum(per_cat.values())
    if total == 0:
        print(f"no device events in {path}")
        return {"total_ms": 0.0, "categories": {}, "top": []}
    print(f"\n== device time by category (total {total:.3f} ms) ==")
    for cat, ms in sorted(per_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {100 * ms / total:5.1f}%  {cat}")
    ops = sorted(((ms, name) for name, ms in per_op.items()), reverse=True)[:top]
    print(f"\n== top {top} ops ==")
    for ms, name in ops:
        print(f"  {ms:9.3f} ms  {100 * ms / total:5.1f}%  {name[:140]}")
    return {"total_ms": total, "categories": dict(per_cat), "top": ops}


def run(phase: str = "s2", batch: int = 16, layers: int = 28, top: int = 40,
        logdir: str = str(Path(__file__).resolve().parents[2] / "build" / "profile_s2")) -> dict:
    """Build, warm up, time and profile one phase; returns parse_trace's
    dict with the untraced best times ("s2_best_ms", "s1_best_ms") and the
    traced phase's wall seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import (
        InternVLAN1Policy,
        to_device,
    )
    from internnav_tpu_torch.model.basemodel.internvla_n1.serving import BatchedN1Policy

    device = require_cuda()
    cfg = InternVLAN1Config.qwen25vl_7b(weight_dtype="int8", kv_dtype="int8",
                                        num_hidden_layers=layers)
    inner = InternVLAN1Policy.build(cfg, device=device)  # seed 0
    inner.tokenizer.eos_token_id = -7  # full decode budget
    policy = BatchedN1Policy(inner, batch_size=batch)

    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, (IMAGE_HW, IMAGE_HW, 3)).astype(np.uint8)
    imgs = np.stack([img] * batch)
    policy.reset([INSTRUCTION] * batch)
    for s in policy.slots:
        s.rgb_list = [img] * 8
        s.episode_idx = 8
        s.s1_mem_frame = to_device(img, device)

    def run_s2():
        return policy.s2_step(imgs, max_new_tokens=DECODE_TOKENS)

    def latents_of(outs):
        return torch.cat([o.output_latent if o.output_latent is not None else torch.zeros(
            (1, cfg.n_query, cfg.text.hidden_size), dtype=cfg.text.dtype, device=device)
            for o in outs], dim=0)

    def run_s1(lat):
        return policy.s1_step_latent(imgs, lat, num_sample_trajs=NUM_SAMPLE_TRAJS)

    print("warmup (captures the decode graph)...", flush=True)
    t0 = time.perf_counter()
    lat = latents_of(run_s2())
    run_s1(lat)
    run_s1(lat)
    torch.cuda.synchronize()
    print(f"warmup done in {time.perf_counter() - t0:.1f}s", flush=True)

    best = {}
    for name, fn in (("s2", run_s2), ("s1", lambda: run_s1(lat))):
        best[name] = float("inf")
        for _ in range(3):  # each call ends by fetching its results to the host
            t0 = time.perf_counter()
            fn()
            best[name] = min(best[name], time.perf_counter() - t0)
        print(f"{name}: best {best[name] * 1e3:.1f} ms", flush=True)

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the device's events
        t0 = time.perf_counter()
        if phase == "s2":
            run_s2()
        elif phase == "s1":
            run_s1(lat)
        else:
            lat2 = latents_of(run_s2())
            run_s1(lat2)
            run_s1(lat2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(logdir, TRACE))
    out = parse_trace(logdir, top)
    print(f"phase {phase}: batch={batch} layers={layers} traced wall {wall * 1e3:.1f} ms "
          f"(profiler on) device {torch.cuda.get_device_name(device)}")
    return {**out, "phase": phase, "traced_wall_ms": wall * 1e3,
            "s2_best_ms": best["s2"] * 1e3, "s1_best_ms": best["s1"] * 1e3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", default="s2", choices=["s2", "s1", "cycle"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--logdir", default=str(Path(__file__).resolve().parents[2] / "build" /
                                            "profile_s2"))
    ap.add_argument("--parse-only", action="store_true", help="only re-parse a saved trace")
    args = ap.parse_args(argv)
    if args.parse_only:
        return parse_trace(args.logdir, args.top)
    return run(args.phase, args.batch, args.layers, args.top, args.logdir)


if __name__ == "__main__":
    main()
