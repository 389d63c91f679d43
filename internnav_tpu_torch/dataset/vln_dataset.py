"""CMA / Seq2Seq imitation-learning dataset + collator.

Port of internnav_tpu/dataset/vln_dataset.py. Reference parity (internnav/dataset/cma_lmdb_dataset.py):
- trajectory records hold per-step rgb/depth/gt actions + instruction
  tokens; failure filtering by minimum frame count (:122 filter_failure),
  stuck-episode tail truncation (drop the last 25 frames of episodes
  marked stuck, :122-140), progress labels, inflection weights (:200-221);
- `cma_collate_fn` pads the time dimension across the batch and transposes
  to time-major (T, N, ...) (:243+), with zero weights at padding.

A synthetic-trajectory writer (`write_synthetic_dataset`) provides the
test fixture / demo data the reference lacks. The collate's resizes are
cv2's without cv2 (`agent.recurrent_agent.resize_bilinear` /
`resize_nearest`, as the recurrent agents resize).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from internnav_tpu_torch.dataset.base import (
    TrajectoryDataset,
    batch_iterator,
    inflection_weights,
)
from internnav_tpu_torch.dataset.traj_store import TrajStore

STUCK_TAIL_FRAMES = 25


def make_failure_filter(min_rgb_nums: int = 5):
    def ok(traj: Dict[str, Any]) -> bool:
        return traj["rgb"].shape[0] >= min_rgb_nums

    return ok


class VLNSampleDataset:
    """Yields per-episode supervision dicts ready for collation."""

    def __init__(self, store_path: str, rank: int = 0, world_size: int = 1,
                 inflection_coef: float = 3.2, min_rgb_nums: int = 5,
                 instr_pad_len: int = 200, seed: int = 0,
                 max_len: Optional[int] = None):
        self.ds = TrajectoryDataset(
            store_path, rank, world_size, seed=seed,
            filter_fn=make_failure_filter(min_rgb_nums),
        )
        self.inflection_coef = inflection_coef
        self.instr_pad_len = instr_pad_len
        self.max_len = max_len

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for traj in self.ds:
            T = traj["rgb"].shape[0]
            if traj.get("stuck") is not None and int(np.asarray(traj["stuck"])) and T > STUCK_TAIL_FRAMES:
                T = T - STUCK_TAIL_FRAMES
            if self.max_len is not None:
                T = min(T, self.max_len)
            actions = np.asarray(traj["actions"][:T], np.int32)
            instr = np.asarray(traj["instruction"], np.int32)
            padded = np.zeros((self.instr_pad_len,), np.int32)
            padded[: min(len(instr), self.instr_pad_len)] = instr[: self.instr_pad_len]
            progress = traj.get("progress")
            if progress is None:
                progress = np.linspace(0, 1, T, dtype=np.float32)
            else:
                progress = np.asarray(progress[:T], np.float32)
            prev_actions = np.concatenate([[0], actions[:-1]]).astype(np.int32)
            yield {
                "rgb": np.asarray(traj["rgb"][:T], np.float32),
                "depth": np.asarray(traj["depth"][:T], np.float32),
                "instruction": padded,
                "actions": actions,
                "prev_actions": prev_actions,
                "progress": progress,
                "weights": inflection_weights(actions, self.inflection_coef),
            }


def cma_collate_fn(samples: List[Dict[str, np.ndarray]],
                   rgb_size: Optional[int] = None,
                   depth_size: Optional[int] = None) -> Dict[str, Any]:
    """Pad time dim, transpose to (T, N, ...) (reference :243+). rgb/depth
    are resized to the policy's canonical resolutions when requested (the
    CMA depth tower flattens its spatial grid, so depth must match the
    training resolution)."""
    if rgb_size or depth_size:
        from internnav_tpu_torch.agent.recurrent_agent import resize_bilinear, resize_nearest

        for s in samples:
            if rgb_size and s["rgb"].shape[1] != rgb_size:
                s["rgb"] = np.stack([resize_bilinear(f, (rgb_size, rgb_size))
                                     for f in s["rgb"]])
            if depth_size and s["depth"].shape[1] != depth_size:
                d = s["depth"]
                if d.ndim == 4:
                    d = d[..., 0]
                s["depth"] = np.stack([resize_nearest(f, (depth_size, depth_size))
                                       for f in d])
    N = len(samples)
    T = max(s["actions"].shape[0] for s in samples)

    def pad_time(x, t_len):
        pad = [(0, t_len - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad)

    rgb = np.stack([pad_time(s["rgb"], T) for s in samples], axis=1)  # (T, N, ...)
    depth = np.stack([pad_time(s["depth"], T) for s in samples], axis=1)
    if depth.ndim == 4:
        depth = depth[..., None]
    actions = np.stack([pad_time(s["actions"], T) for s in samples], axis=1)
    prev = np.stack([pad_time(s["prev_actions"], T) for s in samples], axis=1)
    progress = np.stack([pad_time(s["progress"], T) for s in samples], axis=1)[..., None]
    weights = np.stack([pad_time(s["weights"], T) for s in samples], axis=1)
    instr = np.stack([s["instruction"] for s in samples], axis=0)  # (N, L)
    instr = np.broadcast_to(instr[None], (T,) + instr.shape).copy()
    # masks: 0 at t=0 (episode start), 1 elsewhere within valid steps
    valid = np.stack(
        [np.arange(T) < s["actions"].shape[0] for s in samples], axis=1
    ).astype(np.float32)
    masks = valid.copy()
    masks[0] = 0.0
    return {
        "observations": {
            "rgb": rgb,
            "depth": depth,
            "instruction": instr,
            "progress": progress,
        },
        "corrected_actions": actions,
        "prev_actions": prev,
        "weights": weights * valid,
        "masks": masks,
    }


def make_vln_dataloader(store_path: str, batch_size: int,
                        rgb_size: Optional[int] = 224,
                        depth_size: Optional[int] = 256, **kwargs):
    ds = VLNSampleDataset(store_path, **kwargs)

    def collate(samples):
        return cma_collate_fn(samples, rgb_size=rgb_size, depth_size=depth_size)

    def epoch_iter():
        return batch_iterator(iter(ds), batch_size, collate)

    return epoch_iter


# --------------------------------------------------------------- test data
def write_synthetic_dataset(path: str, n_episodes: int = 8, T: int = 12,
                            hw: int = 64, seed: int = 0) -> str:
    """Write a small synthetic trajectory store (demo/test fixture)."""
    rs = np.random.RandomState(seed)
    store = TrajStore(path, writable=True)
    for i in range(n_episodes):
        t = rs.randint(6, T + 1)
        store.put_tree(
            f"ep{i:04d}",
            {
                "rgb": rs.randint(0, 255, (t, hw, hw, 3)).astype(np.uint8),
                "depth": rs.rand(t, hw, hw).astype(np.float32),
                "instruction": rs.randint(2, 900, size=rs.randint(5, 30)).astype(np.int32),
                "actions": rs.randint(0, 4, t).astype(np.int32),
                "progress": np.linspace(0, 1, t).astype(np.float32),
                "stuck": np.int32(0),
            },
        )
    store.sync()
    store.close()
    return path
