#!/usr/bin/env python3
"""Where the time of one training step goes, for the PyTorch port on a GPU.

    python scripts/torch/profile_train.py [--steps 3]

Builds the same full-width 7B trainer and packed 8192-token row as
`chip_smoke.py`'s train phase (random weights, seed 0), runs one warm-up
step, then per step the seconds of its stages, each timed between device
synchronisations: forward (embed, prefill with remat, chunked CE, System-1
loss), backward (remat recompute and K1/K2/K3), optimizer. Then one more
step under torch.profiler: device-busy seconds, the idle share of that step
with the profiler on, device time by kernel group (the three flash kernels,
matrix products, the rest) and the top kernels.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def kernel_group(name: str) -> str:
    if "flash_fwd" in name:
        return "K1 flash_fwd"
    if "flash_bwd_dkv" in name:
        return "K2 flash_bwd_dkv"
    if "flash_bwd_dq" in name:
        return "K3 flash_bwd_dq"
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "matrix products"
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (
        TRAIN_LEN,
        build_trainer,
        gpu_line,
        packed_row,
        synthetic_store,
    )
    from internnav_tpu_torch import require_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = require_cuda()
    trainer = build_trainer(device)
    prepared = trainer.prepare_batch(packed_row(synthetic_store(), TRAIN_LEN))
    trainer.train_step(prepared)  # warm-up (its update is zero: lr at count 0)
    torch.cuda.synchronize()

    stages = collections.defaultdict(list)
    for _ in range(args.steps):
        marks = [time.perf_counter()]
        trainer.optimizer.zero_grad()
        loss, _ = trainer.loss_fn(prepared)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        trainer.optimizer.step()
        trainer.optimizer.zero_grad()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for name, a, b in zip(("forward", "backward", "optimizer"), marks, marks[1:]):
            stages[name].append(b - a)
        stages["step"].append(marks[-1] - marks[0])
    print("stages (s, median of %d): %s gpu=%r" % (
        args.steps, {k: round(statistics.median(v), 4) for k, v in stages.items()}, gpu_line()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_step(prepared)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    groups = collections.Counter()
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type.name != "CUDA" or evt.self_device_time_total <= 0:
            continue
        sec = evt.self_device_time_total / 1e6
        groups[kernel_group(evt.key)] += sec
        kernels.append((sec, evt.count, evt.key))
    busy = sum(groups.values())
    print(f"profiled step: wall_s={wall:.4f} (profiler on) device_busy_s={busy:.4f} "
          f"idle_share={1 - busy / wall:.4f} gpu={gpu_line()!r}")
    for name, sec in groups.most_common():
        print(f"  group {name}: {sec:.4f} s ({sec / busy:.3f} of device time)")
    for sec, count, name in sorted(kernels, reverse=True)[:15]:
        print(f"  {sec:.4f} s  x{count}  {name[:110]}")


if __name__ == "__main__":
    main()
