"""Convert VLN-CE / StreamVLN-format raw episode data into the native
trajectory store (and optionally a LeRobot-layout directory).

The port's copy of scripts/dataset_converters/vlnce_to_store.py, on the port's
`TrajStore` (it imports nothing of the JAX package).

Reference parity: scripts/dataset_converters/vlnce2lerobot.py:128-620 —
the reference converts raw episodes (per-step jpgs + poses + actions json)
into LeRobot parquet+video datasets. Here the primary sink is the native
traj_store (the framework's training backend); --lerobot also emits the
parquet layout for interchange.

Expected raw layout (StreamVLN-style):
    <raw>/<episode_id>/
        rgb/000000.jpg ...           (or frames.npy)
        depth/000000.png ...         (optional, mm uint16)
        meta.json: {"instruction": str, "actions": [...],
                    "positions": [[x,y],...], "yaws": [...]}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def load_episode(ep_dir: str):
    import cv2

    meta_path = os.path.join(ep_dir, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    rgb_dir = os.path.join(ep_dir, "rgb")
    frames_npy = os.path.join(ep_dir, "frames.npy")
    if os.path.exists(frames_npy):
        rgb = np.load(frames_npy)
    else:
        files = sorted(os.listdir(rgb_dir))
        rgb = np.stack([
            cv2.cvtColor(cv2.imread(os.path.join(rgb_dir, f)), cv2.COLOR_BGR2RGB)
            for f in files
        ])
    depth_dir = os.path.join(ep_dir, "depth")
    depth = None
    if os.path.isdir(depth_dir):
        files = sorted(os.listdir(depth_dir))
        depth = np.stack([
            cv2.imread(os.path.join(depth_dir, f), cv2.IMREAD_UNCHANGED).astype(np.float32) / 1000.0
            for f in files
        ])
    return rgb, depth, meta


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw", required=True, help="raw episode root dir")
    ap.add_argument("--out", required=True, help="output store path (.bin)")
    ap.add_argument("--lerobot", default=None, help="optional LeRobot output dir")
    ap.add_argument("--max-episodes", type=int, default=None)
    args = ap.parse_args()

    from internnav_tpu_torch.dataset.traj_store import TrajStore

    store = TrajStore(args.out, writable=True)
    ep_dirs = sorted(
        d for d in os.listdir(args.raw) if os.path.isdir(os.path.join(args.raw, d))
    )
    if args.max_episodes:
        ep_dirs = ep_dirs[: args.max_episodes]
    n = 0
    for ep_id in ep_dirs:
        try:
            rgb, depth, meta = load_episode(os.path.join(args.raw, ep_id))
        except Exception as e:
            print(f"skip {ep_id}: {e}")
            continue
        tree = {
            "rgb": rgb.astype(np.uint8),
            "actions": np.asarray(meta.get("actions", []), np.int32),
            "positions": np.asarray(meta.get("positions", []), np.float32),
            "yaws": np.asarray(meta.get("yaws", []), np.float32),
            "instruction_text": str(meta.get("instruction", "")),
        }
        if depth is not None:
            tree["depth"] = depth.astype(np.float32)
        if "instruction_tokens" in meta:
            tree["instruction"] = np.asarray(meta["instruction_tokens"], np.int32)
        if "pixel_goals" in meta:
            tree["pixel_goals"] = np.asarray(meta["pixel_goals"], np.int32)
        store.put_tree(ep_id, tree)
        n += 1
    store.sync()
    store.close()
    print(f"wrote {n} episodes to {args.out}")

    if args.lerobot:
        _write_lerobot(args.lerobot, args.out)


def _write_lerobot(out_dir: str, store_path: str) -> None:
    """Emit the parquet side of the LeRobot layout (videos optional)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from internnav_tpu_torch.dataset.traj_store import TrajStore

    store = TrajStore(store_path, writable=False)
    meta_dir = os.path.join(out_dir, "meta")
    os.makedirs(meta_dir, exist_ok=True)
    lines = []
    for idx, key in enumerate(sorted(store.keys())):
        tree = store.get_tree(key)
        chunk = f"chunk-{idx // 1000:03d}"
        data_dir = os.path.join(out_dir, "data", chunk)
        os.makedirs(data_dir, exist_ok=True)
        cols = {
            "action": tree["actions"].tolist(),
            "position": tree["positions"].tolist(),
            "yaw": tree["yaws"].tolist(),
        }
        T = len(cols["action"])
        cols["task"] = [tree.get("instruction_text", "")] * T
        pq.write_table(pa.table(cols),
                       os.path.join(data_dir, f"episode_{idx:06d}.parquet"))
        lines.append({"episode_index": idx, "length": T, "source_key": key})
    with open(os.path.join(meta_dir, "episodes.jsonl"), "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
    print(f"wrote LeRobot layout to {out_dir}")


if __name__ == "__main__":
    main()
