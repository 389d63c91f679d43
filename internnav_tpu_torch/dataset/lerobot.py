"""LeRobot-format dataset reading (parquet + mp4), host-side.

Port of internnav_tpu/dataset/lerobot.py: `LeRobotEpisodeReader` and
`LerobotAsTrajStore`, pyarrow and cv2 imported inside the functions that
use them.

Reference parity: the CMA/RDP LeRobot datasets and `LerobotAsLmdb` adapter
(internnav/dataset/{cma,rdp}_lerobot_dataset.py, internnav/utils/
lerobot_as_lmdb.py:7-75): per-episode parquet tables holding state/action
columns plus mp4-encoded camera streams; the adapter presents episodes via
the same dict API as the trajectory store so all sample datasets work on
either backend. Video decoding uses OpenCV (decord/torchcodec are not
installed here) in host worker threads.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def read_episode_parquet(path: str) -> Dict[str, np.ndarray]:
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    out: Dict[str, np.ndarray] = {}
    for name in table.column_names:
        col = table.column(name).to_pylist()
        try:
            out[name] = np.asarray(col)
        except Exception:
            out[name] = np.asarray(col, dtype=object)
    return out


def decode_video(path: str, frame_indices: Optional[List[int]] = None) -> np.ndarray:
    """mp4 → (T, H, W, 3) uint8 RGB frames (cv2-based)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    if frame_indices is None:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    else:
        for idx in frame_indices:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)


class LeRobotEpisodeReader:
    """Reads a LeRobot dataset directory:
        root/
          meta/episodes.jsonl  (or info.json)
          data/chunk-000/episode_000000.parquet
          videos/chunk-000/<camera>/episode_000000.mp4
    and yields episode dicts with the trajectory-store schema
    (rgb / depth / actions / positions / yaws / instruction_text).
    """

    def __init__(self, root: str, camera: str = "observation.images.rgb"):
        self.root = root
        self.camera = camera
        self.episodes = self._list_episodes()

    def _list_episodes(self) -> List[Dict[str, Any]]:
        meta_path = os.path.join(self.root, "meta", "episodes.jsonl")
        eps = []
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        eps.append(json.loads(line))
        else:
            data_dir = os.path.join(self.root, "data")
            for dirpath, _, files in os.walk(data_dir):
                for name in sorted(files):
                    if name.endswith(".parquet"):
                        idx = int("".join(ch for ch in name if ch.isdigit()) or 0)
                        eps.append({"episode_index": idx,
                                    "parquet": os.path.join(dirpath, name)})
        return eps

    def _episode_paths(self, ep: Dict[str, Any]):
        idx = int(ep.get("episode_index", 0))
        chunk = f"chunk-{idx // 1000:03d}"
        parquet = ep.get("parquet") or os.path.join(
            self.root, "data", chunk, f"episode_{idx:06d}.parquet")
        video = os.path.join(self.root, "videos", chunk, self.camera,
                             f"episode_{idx:06d}.mp4")
        return parquet, video

    def __len__(self) -> int:
        return len(self.episodes)

    def read(self, i: int) -> Dict[str, Any]:
        ep = self.episodes[i]
        parquet, video = self._episode_paths(ep)
        cols = read_episode_parquet(parquet)
        out: Dict[str, Any] = {}
        if os.path.exists(video):
            out["rgb"] = decode_video(video)
        # map common LeRobot column names onto the store schema
        mapping = {
            "action": "actions",
            "actions": "actions",
            "observation.state": "state",
            "observation.depth": "depth",
            "position": "positions",
            "positions": "positions",
            "yaw": "yaws",
            "yaws": "yaws",
            "task": "instruction_text",
            "instruction": "instruction_text",
        }
        for src, dst in mapping.items():
            if src in cols and dst not in out:
                v = cols[src]
                is_str = v.dtype.kind in ("O", "U", "S")
                out[dst] = str(v[0]) if dst == "instruction_text" and is_str else v
        for k, v in cols.items():
            out.setdefault(k, v)
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self.read(i)


class LerobotAsTrajStore:
    """Adapter with the TrajStore read API over a LeRobot dir (reference
    LerobotAsLmdb, internnav/utils/lerobot_as_lmdb.py:7-75)."""

    def __init__(self, root: str, camera: str = "observation.images.rgb"):
        self.reader = LeRobotEpisodeReader(root, camera)
        self._keys = [f"ep{i:04d}" for i in range(len(self.reader))]

    def keys(self) -> List[str]:
        return list(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def get_tree(self, key: str) -> Optional[Dict[str, Any]]:
        if key not in self._keys:
            return None
        return self.reader.read(self._keys.index(key))
