"""NavDP trajectory-episode dataset.

Port of internnav_tpu/dataset/navdp_dataset.py, on the port's
`TrajectoryDataset` and `utils/geometry`; with the same store and seed each
sample equals the JAX package's exactly (the `RandomState` goal offsets and
augment noise included). `write_synthetic_navdp_dataset` writes a store
with the fields the samples read (rgb, depth, positions, yaws, hfov).

Reference parity (internnav/dataset/navdp_dataset.py): per-sample —
memory-frame stack (memory_size recent frames), future-pose resampling to
predict_size waypoints, point/image/pixel goal construction (pixel goals
projected from intrinsics/extrinsics, :190), critic labels from
goal-progress of label vs augmented (perturbed) trajectories.

The open3d pointcloud obstacle ranking is replaced by a depth-map
free-space check (open3d is not installed; same signal — penalize
trajectories that pass through close obstacles).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np

from internnav_tpu_torch.dataset.base import TrajectoryDataset, batch_iterator
from internnav_tpu_torch.utils.geometry import camera_intrinsics, to_local_coords


def resample_path(points: np.ndarray, n: int) -> np.ndarray:
    """Arc-length linear resampling of (K, D) → (n, D)."""
    points = np.asarray(points, np.float64)
    if len(points) == 1:
        return np.repeat(points, n, axis=0)
    seg = np.linalg.norm(np.diff(points, axis=0), axis=1)
    cum = np.concatenate([[0], np.cumsum(seg)])
    targets = np.linspace(0, cum[-1], n)
    out = np.empty((n, points.shape[1]))
    for d in range(points.shape[1]):
        out[:, d] = np.interp(targets, cum, points[:, d])
    return out


def critic_label(traj_xy: np.ndarray, goal_xy: np.ndarray,
                 depth: np.ndarray | None = None) -> float:
    """Goal-progress critic target: start-to-goal distance reduction,
    penalized if the path passes very close to obstacles (depth cue)."""
    start_d = np.linalg.norm(goal_xy - traj_xy[0])
    end_d = np.linalg.norm(goal_xy - traj_xy[-1])
    score = float(start_d - end_d)
    if depth is not None and np.asarray(depth).size:
        near = float((np.asarray(depth) < 0.4).mean())
        score -= 2.0 * near * float(np.linalg.norm(traj_xy[-1] - traj_xy[0]) > 0.5)
    return score


class NavDPSampleDataset:
    def __init__(self, store_path: str, rank: int = 0, world_size: int = 1,
                 memory_size: int = 8, predict_size: int = 24,
                 image_hw: int = 224, seed: int = 0):
        self.ds = TrajectoryDataset(store_path, rank, world_size, seed=seed)
        self.memory_size = memory_size
        self.predict_size = predict_size
        self.image_hw = image_hw
        self.rs = np.random.RandomState(seed)

    def _memory_stack(self, frames: np.ndarray, t: int) -> np.ndarray:
        idx = np.clip(np.arange(t - self.memory_size + 1, t + 1), 0, None)
        return frames[idx]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        M, P = self.memory_size, self.predict_size
        for traj in self.ds:
            rgb = np.asarray(traj["rgb"], np.float32) / 255.0
            depth = np.asarray(traj["depth"], np.float32)
            positions = np.asarray(traj["positions"], np.float64)
            yaws = np.asarray(traj["yaws"], np.float64)
            T = rgb.shape[0]
            hfov = float(np.asarray(traj.get("hfov", 90.0)))
            K = camera_intrinsics(rgb.shape[2], rgb.shape[1], hfov)
            for t in range(0, max(T - 2, 1), max((T - 2) // 4, 1)):
                goal_t = min(t + self.rs.randint(4, 16), T - 1)
                goal_local = to_local_coords(
                    positions[goal_t][None], positions[t], yaws[t]
                )[0]
                future = to_local_coords(
                    positions[t : goal_t + 1], positions[t], yaws[t]
                )
                label_path = resample_path(future, P)
                label_actions = np.diff(
                    np.concatenate([np.zeros((1, 2)), label_path], 0), axis=0
                ) * 4.0  # velocity units (x4, reference cumsum(naction/4))
                dyaw = np.zeros((P, 1))
                label = np.concatenate([label_actions, dyaw], axis=1).astype(np.float32)
                augment = label + self.rs.normal(0, 0.3, label.shape).astype(np.float32)

                mem_rgb = self._memory_stack(rgb, t)
                mem_depth = self._memory_stack(depth, t)
                if mem_depth.ndim == 3:
                    mem_depth = mem_depth[..., None]
                # image goal: goal frame stacked with current frame (6ch)
                goal_image = np.concatenate([rgb[goal_t], rgb[t]], axis=-1)
                # pixel goal: current rgb + depth + 2ch pixel mask + 1 pad = 7ch
                u = np.clip(K[0, 0] * goal_local[1] / max(goal_local[0], 1e-3)
                            + K[0, 2], 0, rgb.shape[2] - 1)
                mask = np.zeros(rgb.shape[1:3] + (2,), np.float32)
                mask[:, int(u), 0] = 1.0
                d_t = mem_depth[-1].reshape(rgb.shape[1:3] + (1,))
                goal_pixel = np.concatenate(
                    [rgb[t], d_t, mask,
                     np.zeros(rgb.shape[1:3] + (1,), np.float32)], axis=-1)  # 7ch
                yield {
                    "goal_point": np.asarray(
                        [goal_local[0], goal_local[1], 0.0], np.float32),
                    "goal_image": goal_image.astype(np.float32),
                    "goal_pixel": goal_pixel.astype(np.float32),
                    "input_images": mem_rgb.astype(np.float32),
                    "input_depths": mem_depth.astype(np.float32),
                    "output_actions": label,
                    "augment_actions": augment,
                    "label_critic": np.float32(
                        critic_label(label_path, goal_local[:2])),
                    "augment_critic": np.float32(critic_label(
                        np.cumsum(augment[:, :2] / 4.0, 0), goal_local[:2],
                        mem_depth[-1])),
                }


def navdp_collate_fn(samples: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
    stack = lambda k: np.stack([s[k] for s in samples])
    return {
        "observations": {
            "goal_point": stack("goal_point"),
            "goal_image": stack("goal_image"),
            "goal_pixel": stack("goal_pixel"),
            "input_images": stack("input_images"),
            "input_depths": stack("input_depths"),
            "output_actions": stack("output_actions"),
            "augment_actions": stack("augment_actions"),
        },
        "label_critic": stack("label_critic"),
        "augment_critic": stack("augment_critic"),
    }


def make_navdp_dataloader(store_path: str, batch_size: int, **kwargs):
    ds = NavDPSampleDataset(store_path, **kwargs)

    def epoch_iter():
        return batch_iterator(iter(ds), batch_size, navdp_collate_fn)

    return epoch_iter


def write_synthetic_navdp_dataset(path: str, n_episodes: int = 4, T: int = 16, hw: int = 64,
                                  seed: int = 0, hfov: float = 90.0) -> str:
    """A store of n_episodes random walks of 8..T steps: uint8 RGB frames,
    depth in metres (some of it nearer than the critic's 0.4 m), (x, y)
    positions 0.2 m apart and their yaws."""
    from internnav_tpu_torch.dataset.traj_store import TrajStore

    rs = np.random.RandomState(seed)
    store = TrajStore(path, writable=True)
    for i in range(n_episodes):
        t = rs.randint(8, T + 1)
        yaws = np.cumsum(rs.uniform(-0.2, 0.2, t))
        steps = 0.2 * np.stack([np.cos(yaws), np.sin(yaws)], 1)
        positions = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, 0)[:-1]], 0)
        store.put_tree(f"ep{i:04d}", {
            "rgb": rs.randint(0, 255, (t, hw, hw, 3)).astype(np.uint8),
            "depth": rs.uniform(0.2, 5.0, (t, hw, hw)).astype(np.float32),
            "positions": positions.astype(np.float32),
            "yaws": yaws.astype(np.float32),
            "hfov": np.float32(hfov),
        })
    store.sync()
    store.close()
    return path
