#!/usr/bin/env python3
"""Device time of NextDiT's feed-forward, of one velocity and of a System-1
denoise, as a checkout runs them on the card.

    python scripts/torch/k8_rows.py [--tree DIR] [--rows 1024 3072 12288 1000]

Imports `internnav_tpu_torch` (and chip_smoke's timer, peaks and bound)
from DIR, the root of a checkout (by default the one this script is in),
so one card can time a parent commit's `git archive` and this tree in
turns. Weights are random
(seed 0, nn.Linear's initialization), bf16, at the 7B policy's System-1
width (NextDiT dim 384, 12 layers, 1,024-wide feed-forward, 768-wide
conditioning of 36 tokens: 4 latent queries and 32 memory tokens).

1. "ffn" rows, for each M: the tree's `LuminaFeedForward` (dim 384) under
   inference mode on an (M, 384) input, the path's own dispatch (two
   products and K8, or K8f where the tree has it), and, where the tree has
   K8f, K8f alone beside the sequence it replaces (two torch.matmul and
   K8), each timed by `chip_smoke.cuda_ms` (events after a device sleep:
   device time); the bound of the two products with the SwiGLU, the larger
   of 4 M N K bf16 flops and x, W1, W3 and out moved once over chip_smoke's
   peaks (`chip_smoke._bytes_bound`); and the host µs a call of the block, of the replaced
   sequence and of K8f's wrapper (400 calls back to back without a
   synchronize, the least and the median of 5 such rounds).
2. "velocity" rows: one NextDiT forward (32 samples of 32 steps a stream)
   at 1 stream and at the 12-stream group: host ms (wall clock to a
   synchronize, median and least of 20), device busy ms and device kernels
   (the sum of its kernels' durations and their count in a torch.profiler
   trace: the host's launches outlast the device's work, so events around
   the call would time the host), and K8's and K8f's launches.
3. "denoise" rows: a System-1 denoise (`InternVLAN1Model._denoise_hidden`:
   10 Euler steps of the action encoder, NextDiT and the action decoder) at
   1 stream and at 12: host ms (median and least of 10), device busy ms
   and device kernels as above, and its launches.
Prints one JSON object a line, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

DIM, INNER, K_COND = 384, 1024, 36
SAMPLES, STEPS = 32, 32
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def launches(act) -> dict:
    return {"K8": act.silu_launches, "K8f": getattr(act, "swiglu_gemm_launches", 0)}


def host_ms(fn, reps: int) -> dict:
    """The median and the least wall ms of fn to a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return {"host_ms": statistics.median(times), "host_min_ms": min(times)}


def host_us(fn, calls: int = 400, rounds: int = 5) -> list:
    """[least, median] host µs a call over `rounds` rounds of `calls` calls
    made back to back, each round ended by a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return [min(per_call), statistics.median(per_call)]


def device_profile(fn) -> dict:
    """The summed durations of fn's device events in a profiler trace, and
    how many of them are kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return {"device_busy_ms": sum(float(e.get("dur", 0.0)) for e in device) / 1e3,
            "device_kernels": sum(e.get("cat") == "kernel" for e in device)}


def system1(device):
    """NextDiT at the 7B width with its action encoder and decoder, and the
    denoise of `InternVLAN1Model` bound to them."""
    import torch

    from internnav_tpu_torch.model.basemodel.internvla_n1 import model as m
    from internnav_tpu_torch.model.basemodel.internvla_n1.nextdit import NextDiT, NextDiTConfig
    from internnav_tpu_torch.ops.schedulers import FlowMatchEulerScheduler

    class S1(torch.nn.Module):
        nextdit_velocity = m.InternVLAN1Model.nextdit_velocity
        _denoise_hidden = m.InternVLAN1Model._denoise_hidden

        def __init__(self):
            super().__init__()
            self.cfg = m.InternVLAN1Config.qwen25vl_7b(num_hidden_layers=1)
            cfg = NextDiTConfig(latent_embedding_size=m.LATENT_EMB_SIZE, dtype=torch.bfloat16)
            self.traj_dit = NextDiT(cfg)
            self.action_encoder = torch.nn.Linear(3, cfg.dim, dtype=torch.bfloat16)
            self.action_decoder = torch.nn.Linear(cfg.dim, 3, dtype=torch.bfloat16)
            self.noise_scheduler = FlowMatchEulerScheduler()

    torch.manual_seed(0)
    return S1().to(device).eval()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--rows", type=int, nargs="+", default=[1024, 3072, 12288, 1000])
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch

    from chip_smoke import PEAK_BF16_FLOPS, _bytes_bound, cuda_ms, gpu_line
    from internnav_tpu_torch.model.basemodel.internvla_n1.nextdit import LuminaFeedForward
    from internnav_tpu_torch.ops import activations as act

    if not torch.cuda.is_available():
        raise SystemExit("k8_rows: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    gpu = gpu_line()
    fused = hasattr(act, "swiglu_gemm_cuda")
    torch.manual_seed(0)
    ffn = LuminaFeedForward(DIM, 256, torch.bfloat16).to(device)
    if ffn.linear_1.out_features != INNER:
        raise AssertionError(f"NextDiT's feed-forward is {ffn.linear_1.out_features} wide")
    g = torch.Generator(device=device).manual_seed(1)
    w1, w3 = ffn.linear_1.weight.detach(), ffn.linear_3.weight.detach()
    with torch.inference_mode():
        for M in args.rows:
            x = torch.randn(M, DIM, generator=g, device=device).bfloat16()
            row = {"tree": tree, "kind": "ffn", "M": M, "N": INNER, "K": DIM, "fused": fused,
                   "block_ms": cuda_ms(lambda: ffn(x)),
                   "bound_ms": _bytes_bound(2.0 * (M * DIM + 2 * INNER * DIM + M * INNER),
                                            4.0 * M * INNER * DIM, PEAK_BF16_FLOPS)[0],
                   "replaced_ms": cuda_ms(lambda: act.silu_cuda(torch.matmul(x, w1.t()),
                                                                torch.matmul(x, w3.t())))}
            row["block_host_us"] = host_us(lambda: ffn(x))
            row["replaced_host_us"] = host_us(
                lambda: act.silu_mul(torch.nn.functional.linear(x, w1),
                                     torch.nn.functional.linear(x, w3)))
            if fused:
                row["k8f_ms"] = cuda_ms(lambda: act.swiglu_gemm_cuda(x, w1, w3))
                row["k8f_host_us"] = host_us(lambda: act.swiglu_gemm_cuda(x, w1, w3))
            before = launches(act)
            ffn(x)
            torch.cuda.synchronize()
            row["launches"] = {k: v - before[k] for k, v in launches(act).items()}
            print(json.dumps({**row, "gpu": gpu}), flush=True)

        s1 = system1(device)
        for streams in (1, 12):
            B = streams
            hidden = torch.randn(B, K_COND, 768, generator=g, device=device).bfloat16()
            feats = torch.randn(B * SAMPLES, STEPS, 3, generator=g, device=device)
            t = torch.full((B,), 0.5, device=device)
            x_init = torch.randn(B * SAMPLES, STEPS, 3, generator=g, device=device)

            def velocity():
                return s1.nextdit_velocity(feats, t, hidden, num_samples=SAMPLES)

            def denoise():
                return s1._denoise_hidden(hidden, 1.0, 10, SAMPLES, x_init=x_init)

            counts = collections.OrderedDict()
            for name, fn in (("velocity", velocity), ("denoise", denoise)):
                before = launches(act)
                out = fn()
                torch.cuda.synchronize()
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"{name} at {streams} streams: not finite")
                counts[name] = {k: v - before[k] for k, v in launches(act).items()}
            for name, fn, reps in (("velocity", velocity, 20), ("denoise", denoise, 10)):
                print(json.dumps({"tree": tree, "kind": name, "streams": streams,
                                  "M": B * SAMPLES * STEPS, **host_ms(fn, reps),
                                  **device_profile(fn), "launches": counts[name],
                                  "gpu": gpu}), flush=True)


if __name__ == "__main__":
    main()
