"""RDP continuous-action training dataset.

Port of internnav_tpu/dataset/rdp_dataset.py. Reference parity (internnav/dataset/rdp_lmdb_dataset.py): per-step samples
with local-frame future waypoints via compute_actions/to_local_coords
(internnav/utils/geometry_utils.py:138/52), [-1,1] normalization against
dataset action stats, prev-action windows, progress / stop-progress labels.
`write_synthetic_rdp_dataset` takes the depth frame's side apart from the
RGB one's (`depth_hw`, default `hw`), so a fixture can hold the
reference's 224 RGB and 256 depth.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from internnav_tpu_torch.dataset.base import TrajectoryDataset, batch_iterator
from internnav_tpu_torch.utils.geometry import compute_actions, get_delta, normalize_data

ACTION_STATS = {"min": np.asarray([-0.25, -0.25, -0.27]),
                "max": np.asarray([0.25, 0.25, 0.27])}


class RDPSampleDataset:
    """Yields per-step supervision: obs at t + normalized future deltas."""

    def __init__(self, store_path: str, rank: int = 0, world_size: int = 1,
                 len_traj_pred: int = 8, len_traj_act: int = 4,
                 instr_pad_len: int = 80, stride: int = 4, seed: int = 0):
        self.ds = TrajectoryDataset(store_path, rank, world_size, seed=seed)
        self.len_traj_pred = len_traj_pred
        self.len_traj_act = len_traj_act
        self.instr_pad_len = instr_pad_len
        self.stride = stride

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for traj in self.ds:
            T = traj["rgb"].shape[0]
            positions = np.asarray(traj["positions"], np.float64)  # (T, 2)
            yaws = np.asarray(traj["yaws"], np.float64)  # (T,)
            instr = np.asarray(traj["instruction"], np.int32)
            padded = np.ones((self.instr_pad_len,), np.int32)  # roberta pad=1
            padded[: min(len(instr), self.instr_pad_len)] = instr[: self.instr_pad_len]
            for t in range(0, T, self.stride):
                future = compute_actions(
                    positions, yaws, t, self.len_traj_pred, learn_angle=True
                )  # (P, 3) cumulative local waypoints
                deltas = get_delta(future)
                norm = normalize_data(deltas, ACTION_STATS).astype(np.float32)
                # prev-action window: last len_traj_act deltas, newest first
                prev = np.zeros((self.len_traj_act, 3), np.float32)
                for j in range(self.len_traj_act):
                    src = t - 1 - j
                    if src >= 0:
                        prev[j] = compute_actions(positions, yaws, src, 1,
                                                  learn_angle=True)[0]
                depth = np.asarray(traj["depth"][t], np.float32)
                if depth.ndim == 2:
                    depth = depth[..., None]
                yield {
                    "rgb": np.asarray(traj["rgb"][t], np.float32),
                    "depth": depth,
                    "instruction": padded,
                    "imu": np.asarray([positions[t, 0], positions[t, 1], yaws[t]],
                                      np.float32),
                    "actions": np.clip(norm, -1.0, 1.0),
                    "prev_actions": prev,
                    "progress": np.float32(t / max(T - 1, 1)),
                    "stop_progress": np.float32(t >= T - self.len_traj_pred),
                    "mask": np.float32(0.0 if t == 0 else 1.0),
                }


def rdp_collate_fn(samples: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
    stack = lambda k: np.stack([s[k] for s in samples])
    return {
        "observations": {
            "rgb": stack("rgb"),
            "depth": stack("depth"),
            "instruction": stack("instruction"),
            "imu": stack("imu"),
            "actions": stack("actions"),
        },
        "prev_actions": stack("prev_actions"),
        "masks": stack("mask"),
        "progress": stack("progress"),
        "stop_progress": stack("stop_progress"),
    }


def make_rdp_dataloader(store_path: str, batch_size: int, **kwargs):
    ds = RDPSampleDataset(store_path, **kwargs)

    def epoch_iter():
        return batch_iterator(iter(ds), batch_size, rdp_collate_fn)

    return epoch_iter


def write_synthetic_rdp_dataset(path: str, n_episodes: int = 4, T: int = 16,
                                hw: int = 64, seed: int = 0,
                                depth_hw: Optional[int] = None) -> str:
    from internnav_tpu_torch.dataset.traj_store import TrajStore

    dhw = hw if depth_hw is None else depth_hw
    rs = np.random.RandomState(seed)
    store = TrajStore(path, writable=True)
    for i in range(n_episodes):
        t = rs.randint(8, T + 1)
        yaws = np.cumsum(rs.uniform(-0.2, 0.2, t))
        steps = 0.2 * np.stack([np.cos(yaws), np.sin(yaws)], 1)
        positions = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, 0)[:-1]], 0)
        store.put_tree(f"ep{i:04d}", {
            "rgb": rs.randint(0, 255, (t, hw, hw, 3)).astype(np.uint8),
            "depth": rs.rand(t, dhw, dhw).astype(np.float32),
            "instruction": rs.randint(2, 900, size=12).astype(np.int32),
            "positions": positions.astype(np.float32),
            "yaws": yaws.astype(np.float32),
            "actions": rs.randint(0, 4, t).astype(np.int32),
        })
    store.sync()
    store.close()
    return path
