#!/usr/bin/env python3
"""Generate a synthetic R2R-style episode dataset (json.gz) for offline /
smoke evaluation without simulator assets.

The port's own copy of scripts/tools/make_fake_dataset.py: the same
schema, draws and command line, without the JAX package.

    python scripts/torch/make_fake_dataset.py --out data/fake_r2r --n 8

Creates <out>/<split>/<split>.json.gz in the VLN-CE episode schema that
internnav_tpu_torch.env.episodes.load_r2r_episodes reads (the configs
scripts/torch/configs/fake_*_cfg.py evaluate data/fake_r2r).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os

import numpy as np


def make_split(out_dir: str, split: str, n: int, seed: int = 0) -> str:
    rs = np.random.RandomState(seed)
    episodes = []
    for i in range(n):
        k = rs.randint(3, 8)
        # random walk reference path in the plane
        steps = rs.uniform(0.5, 2.0, size=(k, 1)) * np.stack(
            [np.cos(th := rs.uniform(-1, 1, size=k)), np.sin(th)], axis=1
        )
        path = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, axis=0)], axis=0)
        ref = np.concatenate([path, np.zeros((k + 1, 1))], axis=1)
        geo = float(np.linalg.norm(np.diff(path, axis=0), axis=1).sum())
        episodes.append(
            {
                "episode_id": str(i),
                "trajectory_id": str(1000 + i),
                "scene_id": f"scene{i % 3}",
                "instruction": {
                    "instruction_text": f"walk along corridor {i} then stop",
                    "instruction_tokens": rs.randint(2, 900, size=rs.randint(5, 30)).tolist(),
                },
                "start_position": ref[0].tolist(),
                "start_rotation": [1.0, 0.0, 0.0, 0.0],
                "reference_path": ref.tolist(),
                "info": {"geodesic_distance": geo},
            }
        )
    split_dir = os.path.join(out_dir, split)
    os.makedirs(split_dir, exist_ok=True)
    path_out = os.path.join(split_dir, f"{split}.json.gz")
    with gzip.open(path_out, "wt") as f:
        json.dump({"episodes": episodes}, f)
    return path_out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/fake_r2r")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--splits", nargs="+", default=["val_unseen"])
    args = ap.parse_args()
    for s in args.splits:
        p = make_split(args.out, s, args.n)
        print("wrote", p)
