"""Episode loading and sharding.

Reference surface: internnav/env/utils/episode_loader/ —
BasePathKeyEpisodeloader (base.py:4-54) loads R2R-style json.gz per split,
shards rank::world_size, filters stairs/skip lists;
ResumablePathKeyEpisodeloader (resumable.py:11-77) drops path_keys already
recorded as done in the per-rank resume store, honoring a retry_list.

Copy of internnav_tpu/env/episodes.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclass
class Episode:
    episode_id: str
    trajectory_id: str
    scene_id: str
    instruction_text: str
    instruction_tokens: Optional[np.ndarray]
    start_position: np.ndarray
    start_rotation: np.ndarray  # quaternion (w, x, y, z) or yaw scalar array
    reference_path: np.ndarray  # (K, 3)
    geodesic_distance: float
    split: str = "val_unseen"
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def path_key(self) -> str:
        return f"{self.scene_id}_{self.trajectory_id}_{self.episode_id}"


def load_r2r_episodes(
    path: str,
    split: str = "val_unseen",
    filter_stairs: bool = False,
    max_episodes: Optional[int] = None,
) -> List[Episode]:
    """Load a VLN-CE/R2R-style json.gz ({'episodes': [...]}).

    Accepts both raw .json and .json.gz files (reference dataset_utils.py
    load_data semantics, minus the Isaac-specific trajectory revision).
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    episodes_raw = data["episodes"] if isinstance(data, dict) else data
    out: List[Episode] = []
    for ep in episodes_raw:
        info = ep.get("info", {})
        ref_path = np.asarray(
            ep.get("reference_path") or ep.get("gt_locations") or [ep.get("goals", [{}])[0].get("position", [0, 0, 0])],
            dtype=np.float64,
        )
        if filter_stairs and info.get("has_stairs", False):
            continue
        instr = ep.get("instruction", {})
        if isinstance(instr, dict):
            text = instr.get("instruction_text", "")
            tokens = instr.get("instruction_tokens")
        else:
            text, tokens = str(instr), None
        geo = info.get("geodesic_distance", ep.get("geodesic_distance"))
        if geo is None:
            geo = float(np.linalg.norm(ref_path[-1][:2] - ref_path[0][:2]))
        out.append(
            Episode(
                episode_id=str(ep.get("episode_id", len(out))),
                trajectory_id=str(ep.get("trajectory_id", "")),
                scene_id=str(ep.get("scene_id", "")),
                instruction_text=text,
                instruction_tokens=np.asarray(tokens, dtype=np.int32) if tokens is not None else None,
                start_position=np.asarray(ep.get("start_position", ref_path[0]), dtype=np.float64),
                start_rotation=np.asarray(ep.get("start_rotation", [1, 0, 0, 0]), dtype=np.float64),
                reference_path=ref_path,
                geodesic_distance=float(geo),
                split=split,
            )
        )
        if max_episodes is not None and len(out) >= max_episodes:
            break
    return out


def shard_episodes(episodes: Sequence[Episode], rank: int, world_size: int) -> List[Episode]:
    """rank::world_size sharding (reference habitat_env.py:72)."""
    return list(episodes[rank::world_size])


def group_by_scene(episodes: Sequence[Episode]) -> List[Episode]:
    """Stable scene grouping so each rank loads few scenes
    (reference habitat_env.py:66-72 sorts episodes by scene)."""
    return sorted(episodes, key=lambda e: (e.scene_id, e.episode_id))


class ResumableEpisodeLoader:
    """Filters out episodes already recorded as done in a resume store.

    The store is any object with `done_keys() -> set[str]` and an optional
    `failed_keys() -> dict[key, fail_reason]` (see evaluator/utils/
    data_collector.py). retry_list re-queues selected failure classes
    (reference resumable.py:43-72).
    """

    def __init__(self, episodes: Sequence[Episode], store=None,
                 retry_list: Sequence[str] = ()):
        self.all_episodes = list(episodes)
        self.store = store
        self.retry_list = list(retry_list)

    def pending(self) -> List[Episode]:
        if self.store is None:
            return list(self.all_episodes)
        done = set(self.store.done_keys())
        if self.retry_list:
            failed = self.store.failed_keys()
            retry = {k for k, reason in failed.items() if any(r in str(reason) for r in self.retry_list)}
            done -= retry
        return [e for e in self.all_episodes if e.path_key not in done]
