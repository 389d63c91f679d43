"""Write LeRobot-format datasets (parquet + mp4 + meta) from the native
trajectory store or VLN-CE episode dicts.

The port's copy of scripts/dataset_converters/store_to_lerobot.py, on the port's
`TrajStore` (it imports nothing of the JAX package).

Reference parity: scripts/dataset_converters/vlnce2lerobot.py:128-620 —
the reference builds on the `lerobot` library's LeRobotDataset writer
(v2.1 layout). That library isn't installed here, so this is a
dependency-light writer emitting the same directory layout that both this
repo's readers (internnav_tpu_torch/dataset/lerobot.py) and the reference's
LeRobot consumers read:

    root/
      meta/info.json             (fps, features, counts, codebase_version)
      meta/tasks.jsonl           ({task_index, task})
      meta/episodes.jsonl        ({episode_index, tasks, length})
      meta/episodes_stats.jsonl  (per-episode per-feature min/max/mean/std)
      data/chunk-000/episode_000000.parquet
      videos/chunk-000/<camera>/episode_000000.mp4

Usage:
    python scripts/torch/store_to_lerobot.py \
        --store data/traj_store --out data/lerobot_ds [--fps 10]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

CODEBASE_VERSION = "v2.1"
DEFAULT_CAMERA = "observation.images.rgb"


class LeRobotWriter:
    """Incremental LeRobot-layout dataset writer (parquet via pyarrow,
    videos via cv2)."""

    def __init__(self, root: str, fps: int = 10,
                 camera: str = DEFAULT_CAMERA, robot_type: str = "vln"):
        self.root = Path(root)
        self.fps = fps
        self.camera = camera
        self.robot_type = robot_type
        self.episodes: List[Dict[str, Any]] = []
        self.episode_stats: List[Dict[str, Any]] = []
        self.tasks: Dict[str, int] = {}
        self.total_frames = 0
        self.features: Dict[str, Dict[str, Any]] = {}
        (self.root / "meta").mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------ episodes
    def _chunk(self, idx: int) -> str:
        return f"chunk-{idx // 1000:03d}"

    def _task_index(self, task: str) -> int:
        if task not in self.tasks:
            self.tasks[task] = len(self.tasks)
        return self.tasks[task]

    def add_episode(self, episode: Dict[str, Any]) -> int:
        """episode: trajectory-store schema — rgb (T,H,W,3) uint8 optional,
        actions (T,) or (T,D), positions (T,3), yaws (T,), instruction_text
        str, plus any extra (T, ...) arrays (written as extra columns)."""
        idx = len(self.episodes)
        task = str(episode.get("instruction_text", ""))
        t_idx = self._task_index(task)

        cols: Dict[str, np.ndarray] = {}
        mapping = {"actions": "action", "positions": "position",
                   "yaws": "yaw", "state": "observation.state"}
        length = None
        for src, dst in mapping.items():
            if src in episode and episode[src] is not None:
                v = np.asarray(episode[src])
                cols[dst] = v
                length = len(v) if length is None else min(length, len(v))
        rgb = episode.get("rgb")
        if rgb is not None and len(rgb):
            length = len(rgb) if length is None else min(length, len(rgb))
        if length is None:
            raise ValueError("episode has no per-frame arrays")
        cols = {k: v[:length] for k, v in cols.items()}

        cols["timestamp"] = np.arange(length, dtype=np.float32) / self.fps
        cols["frame_index"] = np.arange(length, dtype=np.int64)
        cols["episode_index"] = np.full(length, idx, np.int64)
        cols["index"] = np.arange(self.total_frames,
                                  self.total_frames + length, dtype=np.int64)
        cols["task_index"] = np.full(length, t_idx, np.int64)
        cols["task"] = np.asarray([task] * length, object)

        self._write_parquet(idx, cols)
        if rgb is not None and len(rgb):
            self._write_video(idx, np.asarray(rgb[:length], np.uint8))
        self._record_features(cols, rgb)
        self.episodes.append(
            {"episode_index": idx, "tasks": [task], "length": int(length)})
        self.episode_stats.append(
            {"episode_index": idx, "stats": _stats(cols)})
        self.total_frames += length
        return idx

    def _write_parquet(self, idx: int, cols: Dict[str, np.ndarray]) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        d = self.root / "data" / self._chunk(idx)
        d.mkdir(parents=True, exist_ok=True)
        arrays, names = [], []
        for k, v in cols.items():
            names.append(k)
            if v.dtype == object:
                arrays.append(pa.array(v.tolist(), pa.string()))
            elif v.ndim == 1:
                arrays.append(pa.array(v))
            else:  # (T, D) fixed-size lists
                flat = v.reshape(len(v), -1)
                arrays.append(pa.array(list(flat)))
        pq.write_table(pa.table(dict(zip(names, arrays))),
                       d / f"episode_{idx:06d}.parquet")

    def _write_video(self, idx: int, rgb: np.ndarray) -> None:
        import cv2

        d = self.root / "videos" / self._chunk(idx) / self.camera
        d.mkdir(parents=True, exist_ok=True)
        path = str(d / f"episode_{idx:06d}.mp4")
        h, w = rgb.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             self.fps, (w, h))
        if not vw.isOpened():  # codec fallback
            path = path[:-4] + ".avi"
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"),
                                 self.fps, (w, h))
        for frame in rgb:
            vw.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        vw.release()

    def _record_features(self, cols: Dict[str, np.ndarray],
                         rgb: Optional[np.ndarray]) -> None:
        for k, v in cols.items():
            if k in self.features:
                continue
            if v.dtype == object:
                self.features[k] = {"dtype": "string", "shape": [1]}
            else:
                self.features[k] = {"dtype": str(v.dtype),
                                    "shape": list(v.shape[1:]) or [1]}
        if rgb is not None and self.camera not in self.features:
            self.features[self.camera] = {
                "dtype": "video", "shape": list(rgb.shape[1:]),
                "info": {"video.fps": self.fps, "video.codec": "mp4v"},
            }

    # -------------------------------------------------------------- finish
    def finalize(self) -> None:
        meta = self.root / "meta"
        with open(meta / "episodes.jsonl", "w") as f:
            for ep in self.episodes:
                f.write(json.dumps(ep) + "\n")
        with open(meta / "tasks.jsonl", "w") as f:
            for task, i in sorted(self.tasks.items(), key=lambda kv: kv[1]):
                f.write(json.dumps({"task_index": i, "task": task}) + "\n")
        with open(meta / "episodes_stats.jsonl", "w") as f:
            for st in self.episode_stats:
                f.write(json.dumps(st) + "\n")
        n_video = sum(1 for v in self.features.values()
                      if v["dtype"] == "video")
        info = {
            "codebase_version": CODEBASE_VERSION,
            "robot_type": self.robot_type,
            "fps": self.fps,
            "total_episodes": len(self.episodes),
            "total_frames": self.total_frames,
            "total_tasks": len(self.tasks),
            "total_videos": n_video * len(self.episodes),
            "chunks_size": 1000,
            "data_path": "data/chunk-{episode_chunk:03d}/"
                         "episode_{episode_index:06d}.parquet",
            "video_path": "videos/chunk-{episode_chunk:03d}/{video_key}/"
                          "episode_{episode_index:06d}.mp4",
            "features": self.features,
        }
        with open(meta / "info.json", "w") as f:
            json.dump(info, f, indent=2)


def _stats(cols: Dict[str, np.ndarray]) -> Dict[str, Dict[str, Any]]:
    out = {}
    for k, v in cols.items():
        if v.dtype == object:
            continue
        a = np.asarray(v, np.float64).reshape(len(v), -1)
        out[k] = {"min": a.min(0).tolist(), "max": a.max(0).tolist(),
                  "mean": a.mean(0).tolist(), "std": a.std(0).tolist(),
                  "count": [len(a)]}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", required=True,
                    help="native trajectory store directory")
    ap.add_argument("--out", required=True, help="LeRobot output root")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--camera", default=DEFAULT_CAMERA)
    args = ap.parse_args()

    from internnav_tpu_torch.dataset.traj_store import TrajStore

    store = TrajStore(args.store)
    writer = LeRobotWriter(args.out, fps=args.fps, camera=args.camera)
    for key in store.keys():
        ep = store.get_tree(key)
        if ep is None:
            continue
        writer.add_episode(ep)
    writer.finalize()
    print(f"wrote {len(writer.episodes)} episodes, "
          f"{writer.total_frames} frames -> {args.out}")


if __name__ == "__main__":
    main()
