#!/usr/bin/env python3
"""InternVLA-N1 offline inference demo: the dual system on a folder of frames, no simulator.

Port of scripts/notebooks/inference_demo.py (the reference's
scripts/notebooks/inference_only_demo.ipynb as a script). Each frame goes
through the System-2 step (16 new tokens); the script prints the System-2
text, then the pixel goal and System-1's actions (8 samples) where the
text holds one, else System-2's actions.

    python scripts/torch/inference_demo.py [--frames DIR] [--instruction TEXT] [--ckpt DIR]
    python scripts/torch/inference_demo.py --device cpu            # the tiny config on the host

Frames: the .jpg / .jpeg / .png files of `--frames` in name order, read
with PIL as RGB and resized to `--image-hw` (the port's resize,
`policy._resize_frames`); without `--frames`, six RandomState(0) frames.
Weights: random (`InternVLAN1Policy.build`, seed 0), or a native directory
of the port (`--ckpt`, `InternVLAN1Policy.from_pretrained`; the config must
match it). The config: `--config tiny` (the JAX demo's tiny nextdit_async
config, in bf16), the default on the host; `--config 7b` (Qwen2.5-VL-7B
dims at `--layers` decoder layers), the default on the card, whose
attention kernels take head dims 80 and 128, not the tiny config's 16 and
8. The GPU by default (raises without one); `--device cpu` runs on the
host when asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path
from typing import List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME_SUFFIXES = (".jpg", ".png", ".jpeg")
NEW_TOKENS = 16
NUM_SAMPLE_TRAJS = 8


def load_frames(path: Optional[str], hw: int) -> List[np.ndarray]:
    """The frames of a folder as (hw, hw, 3) uint8 RGB, or six RandomState(0)
    frames without one (the JAX demo's)."""
    from PIL import Image

    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import _resize_frames

    if path is None:
        rs = np.random.RandomState(0)
        return [rs.randint(0, 255, (hw, hw, 3), np.uint8) for _ in range(6)]
    frames = []
    for name in sorted(os.listdir(path)):
        if name.lower().endswith(FRAME_SUFFIXES):
            with Image.open(os.path.join(path, name)) as img:
                rgb = np.asarray(img.convert("RGB"))
            frames.append(_resize_frames(rgb[None], hw)[0])
    return frames


def demo_config(name: str, layers: int):
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config

    if name == "tiny":
        return InternVLAN1Config.tiny("nextdit_async", dtype=torch.bfloat16)
    cfg = InternVLAN1Config.qwen25vl_7b()
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=layers))


def main(argv=None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", default=None, help="a folder of .jpg / .png frames")
    ap.add_argument("--instruction", default="go forward and stop at the door")
    ap.add_argument("--ckpt", default=None, help="a native checkpoint directory of the port")
    ap.add_argument("--image-hw", type=int, default=56)
    ap.add_argument("--config", choices=("tiny", "7b"), default=None,
                    help="tiny on the host, 7b on the card by default")
    ap.add_argument("--layers", type=int, default=28, help="decoder layers of --config 7b")
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (no CPU fallback), or cpu when asked for")
    args = ap.parse_args(argv)

    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

    device = torch.device(args.device)
    if device.type != "cpu":
        device = require_cuda(device)
    cfg = demo_config(args.config or ("tiny" if device.type == "cpu" else "7b"), args.layers)
    if args.ckpt:
        policy = InternVLAN1Policy.from_pretrained(args.ckpt, cfg, device=device)
    else:
        policy = InternVLAN1Policy.build(cfg, device=device, seed=0)

    frames = load_frames(args.frames, args.image_hw)
    lines = []
    for t, frame in enumerate(frames):
        out = policy.s2_step(frame, args.instruction, max_new_tokens=NEW_TOKENS)
        step = [f"[{t}] llm: {policy.llm_output!r}"]
        if out.output_pixel is not None:
            step.append(f"     pixel goal: {out.output_pixel.tolist()}")
        if out.output_latent is not None:
            rgb2 = np.stack([frames[max(t - 1, 0)], frame])[None]
            s1 = policy.s1_step_latent(rgb2, None, out.output_latent,
                                       num_sample_trajs=NUM_SAMPLE_TRAJS)
            step.append(f"     S1 actions: {s1.idx}")
        elif out.output_action is not None:
            step.append(f"     S2 actions: {out.output_action}")
        print("\n".join(step), flush=True)
        lines += step
    return lines


if __name__ == "__main__":
    main()
