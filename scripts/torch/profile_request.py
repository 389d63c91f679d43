#!/usr/bin/env python3
"""Where the time of one serving step goes, for the PyTorch port on a GPU.

    python scripts/torch/profile_request.py [--requests 3] [--profile parity|realtime]
    python scripts/torch/profile_request.py --batched [--requests 2]

Drives the same 7B policy (the `parity` profile's bf16 one by default, or
the `realtime` profile's W8A8 + int8 KV one), agent and seeded 420x420
frames as `chip_smoke.py`'s serve phases, without the HTTP server and with System-1
on every step as well (the action queue is cleared before each one). The
history grows by one frame per step. With --batched it drives instead the
realtime policy behind `PipelinedN1Server` at chip_smoke's serve batched
geometry (4 cohorts x 12 streams, 224x224, saturated histories, shared
grouped decode of the full 20-token budget), a macro-cycle a step. Prints per step the
wall time and the seconds spent in each stage (vision encode, text
prefill, the decode loop, traj-latent chunk, System-1), each stage timed
between device synchronisations, and the decode's host milliseconds per
token (the loop replays a captured CUDA graph per token; a capture,
made when a prompt length is new, falls outside the loop's range); K6b's host
microseconds per call where K6b is called from Python inside the loop.
Then one more step under torch.profiler: device-busy seconds, the idle
share of that step with the profiler on, the top kernels, and per decode
token the device kernels, their device milliseconds and the host
milliseconds (profiler on), and K6b's launches per token, device
microseconds per launch and share of the decode's device time. A decode
token's kernels are those that start on the device inside the loop's
range, divided by its steps: each stage runs between two device
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
    ap.add_argument("--batched", action="store_true",
                    help="the realtime policy behind PipelinedN1Server (4 x 12 streams)")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import gpu_line
    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.model.basemodel.internvla_n1 import decode_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds, calls = collections.defaultdict(float), collections.Counter()

    def timed(obj, name, label):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            with record_function(label):
                torch.cuda.synchronize()
                k6b["on"] = label == "decode_loop"
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                seconds[label] += time.perf_counter() - t
                k6b["on"] = False
            calls[label] += 1
            return out

        setattr(obj, name, wrapper)

    k6b = k6b_host_timer()
    step, describe, stages = (batched_setup if args.batched else agent_setup)(
        args, require_cuda())
    for obj, name, label in stages:
        timed(obj, name, label)
    timed(decode_graph.DecodeLoop, "run", "decode_loop")
    if args.batched:
        step()  # the captures of this geometry's decode graphs (one a geometry)

    for i in range(args.requests):
        seconds.clear()
        calls.clear()
        k6b.update(calls=0, seconds=0.0)
        before = decode_graph.stats["replays"]
        wall = step()
        tokens = max(decode_graph.stats["replays"] - before, 1)
        stage_line = " ".join(f"{k}={v:.4f}s/{calls[k]}" for k, v in seconds.items())
        k6b_line = (f" k6b_calls_per_token={k6b['calls'] / tokens:.2f} k6b_host_us_per_call="
                    f"{1e6 * k6b['seconds'] / k6b['calls']:.2f}" if k6b["calls"] else "")
        print(f"step {i}: wall_s={wall:.4f} {describe()} decode_steps={tokens} {stage_line} "
              f"decode_host_ms_per_token={1e3 * seconds['decode_loop'] / tokens:.4f}{k6b_line}")
    before = decode_graph.stats["replays"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = step()
    steps = decode_graph.stats["replays"] - before
    table = prof.key_averages()
    # device rows; the stages' record_function ranges also show as device
    # annotations spanning their kernels, which are not device work
    busy_s = sum(e.self_device_time_total for e in table
                 if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
                 and e.key not in calls) / 1e6
    print(f"profiled step: wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
          f"idle_share={1 - busy_s / wall:.3f} (profiler on)")
    print(table.table(sort_by="self_device_time_total", row_limit=20, max_name_column_width=60))
    decode_token_kernels(prof, DeviceType, steps)
    print(f"profile={'realtime batched' if args.batched else args.profile} {gpu_line()}")


def agent_setup(args, device):
    """The single-stream agent: (step, its description, stages to time)."""
    import numpy as np
    import torch

    from chip_smoke import INSTRUCTION, build_agent, request_frames

    policy, agent = build_agent(device, args.profile)
    lm = policy.model.language_model
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
    return step, lambda: (f"images={len(policy.input_images)} "
                          f"generated={len(policy.last_gen_tokens)}"), (
        (policy, "_encode_image", "vision_encode"), (lm, "forward", "text_prefill"),
        (policy, "_latent_chunk", "latent_chunk"), (policy, "s1_step_latent", "system1"))


def batched_setup(args, device):
    """chip_smoke's serve batched geometry, one macro-cycle a step."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import to_device
    from internnav_tpu_torch.model.basemodel.internvla_n1.serving import (
        BatchedN1Policy,
        PipelinedN1Server,
    )
    from internnav_tpu_torch.realworld import serve

    policy = serve.build_policy("realtime", device=device)
    policy.tokenizer.eos_token_id = -7  # no token: the full decode budget, as chip_smoke
    server = PipelinedN1Server(policy, cs.BATCH_ROWS, cohorts=cs.BATCH_COHORTS)
    img = np.random.default_rng(0).integers(0, 256, (cs.BATCH_HW, cs.BATCH_HW, 3)).astype(
        np.uint8)
    imgs = np.stack([img] * cs.BATCH_ROWS)
    for pol in server.cohorts:
        pol.reset([cs.INSTRUCTION] * cs.BATCH_ROWS)
        for s in pol.slots:
            s.rgb_list = [img] * 8
            s.episode_idx = 8
            s.s1_mem_frame = to_device(img, device)

    def on_cycle(ci, t, s2out, s1res):
        for s in server.cohorts[ci].slots:
            s.s1_mem_feats = None

    def step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        server.serve_stream(lambda ci, t, ph: imgs, 1, max_new_tokens=cs.BATCH_NEW_TOKENS,
                            num_sample_trajs=cs.BATCH_TRAJS, s1_calls=cs.BATCH_S1_CALLS,
                            on_cycle=on_cycle, shared_decode=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    return step, lambda: f"cohorts={cs.BATCH_COHORTS} rows={cs.BATCH_ROWS}", (
        (policy, "_encode_images", "vision_encode"), (policy, "prefill_s2", "text_prefill"),
        (policy, "_latent_chunk", "latent_chunk"), (BatchedN1Policy, "_s1_dispatch", "system1"))


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


def decode_token_kernels(prof, DeviceType, steps: int) -> None:
    """Per decode token of the profiled step (`steps` tokens in all): the
    device kernels that start inside a `decode_loop` range, their device
    time, the ranges' host time, K6b's share, and the most launched
    kernels."""
    events = prof.events()
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == "decode_loop" and e.device_type == DeviceType.CPU)
    if not windows or not steps:
        raise RuntimeError("the profiled step ran no decode step")
    starts = [w[0] for w in windows]
    per_name = collections.Counter()
    n_kernels, device_us, k6b, k6b_us = 0, 0.0, 0, 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or e.name.startswith(("Memcpy", "Memset")) or e.name == "decode_loop":
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= windows[i][1]:
            n_kernels += 1
            device_us += e.time_range.elapsed_us()
            per_name[e.name] += 1
            if "w8a8" in e.name:  # K6b's kernels
                k6b += 1
                k6b_us += e.time_range.elapsed_us()
    n = steps
    host_ms = sum(b - a for a, b in windows) / n / 1e3
    print(f"profiled decode: tokens={n} kernels_per_token={n_kernels / n:.2f} "
          f"device_ms_per_token={device_us / n / 1e3:.4f} host_ms_per_token={host_ms:.4f} "
          f"idle_share={1 - device_us / n / 1e3 / host_ms:.3f} (profiler on)")
    if not n_kernels:
        print("profiled decode: the profiler saw no device kernel inside the loop's range")
    if k6b:
        print(f"profiled decode: k6b_launches_per_token={k6b / n:.2f} "
              f"k6b_device_us_per_launch={k6b_us / k6b:.3f} "
              f"k6b_device_ms_per_token={k6b_us / n / 1e3:.4f} "
              f"k6b_share_of_decode_device_time={k6b_us / device_us:.3f}")
    for name, count in per_name.most_common(12):
        print(f"  per token {count / n:8.2f}  {name[:100]}")


if __name__ == "__main__":
    main()
