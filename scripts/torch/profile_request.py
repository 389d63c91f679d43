#!/usr/bin/env python3
"""Where the time of one serving step goes, for the PyTorch port on a GPU.

    python scripts/torch/profile_request.py [--requests 3] [--profile parity|realtime]

Drives the same 7B policy (the `parity` profile's bf16 one by default, or
the `realtime` profile's W8A8 + int8 KV one), agent and seeded 420x420
frames as `chip_smoke.py`'s serve phases, without the HTTP server and with System-1
on every step as well (the action queue is cleared before each one). The
history grows by one frame per step. Prints per step the wall time and the
seconds spent in each stage (vision encode, text prefill, decode steps,
lm_head, traj-latent chunk, System-1), each stage timed between device
synchronisations, and the decode's host milliseconds per token; with
W8A8 projections also K6b's host microseconds per call (the Python
wrapper and its C launch, timed on the host clock around the function that
launches the kernel) and its calls per decode token. Then one more step
under torch.profiler: device-busy seconds, the idle share of that step
with the profiler on, the top kernels, and per decode token the device
kernels launched, their device milliseconds and the host milliseconds
(profiler on), and K6b's launches per token and device microseconds per
launch. A decode step's kernels are those that start
on the device inside its range: each stage runs between two device
synchronisations, so its kernels start and end inside it.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--profile", default="parity", choices=("parity", "realtime"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import INSTRUCTION, build_agent, gpu_line, request_frames
    from internnav_tpu_torch import require_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    policy, agent = build_agent(require_cuda(), args.profile)
    seconds, calls = collections.defaultdict(float), collections.Counter()

    def timed(obj, name, label):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            with record_function(label):
                torch.cuda.synchronize()
                k6b["on"] = label == "decode_step"
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                seconds[label] += time.perf_counter() - t
                k6b["on"] = False
            calls[label] += 1
            return out

        setattr(obj, name, wrapper)

    k6b = k6b_host_timer()
    lm = policy.model.language_model
    for obj, name, label in ((policy, "_encode_image", "vision_encode"),
                             (lm, "forward", "text_prefill"), (lm, "decode_step", "decode_step"),
                             (lm, "_logits", "lm_head"), (lm, "decode_chunk", "latent_chunk"),
                             (policy, "s1_step_latent", "system1")):
        timed(obj, name, label)
    rng = np.random.default_rng(0)

    def step():
        agent.action_queue.clear()  # System-1 runs on every step's latent
        rgb, depth = request_frames(rng)
        torch.cuda.synchronize()
        t = time.perf_counter()
        agent.step([{"instruction_text": INSTRUCTION, "rgb": rgb, "depth": depth}])
        torch.cuda.synchronize()
        return time.perf_counter() - t

    agent.reset()
    for i in range(args.requests):
        seconds.clear()
        calls.clear()
        k6b.update(calls=0, seconds=0.0)
        wall = step()
        stages = " ".join(f"{k}={v:.4f}s/{calls[k]}" for k, v in seconds.items())
        tokens = max(calls["decode_step"], 1)
        k6b_line = (f" k6b_calls_per_token={k6b['calls'] / tokens:.2f} k6b_host_us_per_call="
                    f"{1e6 * k6b['seconds'] / k6b['calls']:.2f}" if k6b["calls"] else "")
        print(f"step {i}: wall_s={wall:.4f} images={len(policy.input_images)} "
              f"generated={len(policy.last_gen_tokens)} {stages} decode_host_ms_per_token="
              f"{1e3 * seconds['decode_step'] / tokens:.4f}{k6b_line}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = step()
    table = prof.key_averages()
    # device rows; the stages' record_function ranges also show as device
    # annotations spanning their kernels, which are not device work
    busy_s = sum(e.self_device_time_total for e in table
                 if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
                 and e.key not in calls) / 1e6
    print(f"profiled step: wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
          f"idle_share={1 - busy_s / wall:.3f} (profiler on)")
    print(table.table(sort_by="self_device_time_total", row_limit=20, max_name_column_width=60))
    decode_token_kernels(prof, DeviceType)
    print(f"profile={args.profile} {gpu_line()}")


def k6b_host_timer() -> dict:
    """Wrap the functions of `ops.quant` that launch K6b (the decode
    tiles' launch and the single-projection wrapper, whichever the tree
    has) so that the host time of each outermost call made while
    `state["on"]` is added to state["seconds"] and counted in
    state["calls"]."""
    from internnav_tpu_torch.ops import quant

    state = {"on": False, "calls": 0, "seconds": 0.0, "depth": 0}
    for name in ("_decode_launch", "w8a8_linear_cuda"):
        fn = getattr(quant, name, None)
        if fn is None:
            continue

        def wrapper(*a, _fn=fn, **k):
            state["depth"] += 1
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                state["depth"] -= 1
                if state["on"] and state["depth"] == 0:
                    state["seconds"] += time.perf_counter() - t
                    state["calls"] += 1

        setattr(quant, name, wrapper)
    return state


def decode_token_kernels(prof, DeviceType) -> None:
    """Per decode token of the profiled step: the device kernels that start
    inside a `decode_step` range, their device time, the range's host
    time, and the most launched kernels."""
    events = prof.events()
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == "decode_step" and e.device_type == DeviceType.CPU)
    if not windows:
        raise RuntimeError("the profiled step ran no decode step")
    starts = [w[0] for w in windows]
    per_name = collections.Counter()
    n_kernels, device_us, k6b, k6b_us = 0, 0.0, 0, 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or e.name.startswith(("Memcpy", "Memset")) or e.name == "decode_step":
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= windows[i][1]:
            n_kernels += 1
            device_us += e.time_range.elapsed_us()
            per_name[e.name] += 1
            if "w8a8" in e.name:  # K6b's kernels
                k6b += 1
                k6b_us += e.time_range.elapsed_us()
    n = len(windows)
    host_ms = sum(b - a for a, b in windows) / n / 1e3
    print(f"profiled decode: tokens={n} kernels_per_token={n_kernels / n:.2f} "
          f"device_ms_per_token={device_us / n / 1e3:.4f} host_ms_per_token={host_ms:.4f} "
          f"idle_share={1 - device_us / n / 1e3 / host_ms:.3f} (profiler on)")
    if k6b:
        print(f"profiled decode: k6b_launches_per_token={k6b / n:.2f} "
              f"k6b_device_us_per_launch={k6b_us / k6b:.3f} "
              f"k6b_device_ms_per_token={k6b_us / n / 1e3:.4f}")
    for name, count in per_name.most_common(12):
        print(f"  per token {count / n:8.2f}  {name[:100]}")


if __name__ == "__main__":
    main()
