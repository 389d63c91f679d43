"""Episode → per-episode task config generation.

Reference parity: internnav/env/utils/episode_loader/generate_episode.py
(generate_vln_episode:38-107 builds one VLNEvalTaskCfg per path_key with
robot pose from the episode, metric config, and scene asset resolution;
load_scene_usd:9-26 walks scene dirs for fixed.usd variants). This module
keeps the same shape with backend-neutral asset resolution (usd for
Isaac, glb/ply for habitat).

Copy of internnav_tpu/env/task_gen.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from internnav_tpu_torch.configs.evaluator import MetricCfg, TaskCfg
from internnav_tpu_torch.env.episodes import Episode

SCENE_ASSET_CANDIDATES = (
    "fixed.usd", "fixed_docker.usd", "scene.usd",  # Isaac/InternUtopia
    "mesh.glb", "scene.glb", "mesh_semantic.ply",  # habitat
)


def load_scene_asset(scene_data_dir: str, scene_id: str) -> Optional[str]:
    """Resolve the scene asset file for a scene id (reference
    load_scene_usd semantics: walk the scene dir, prefer fixed variants)."""
    base = os.path.join(scene_data_dir, scene_id)
    if not os.path.isdir(base):
        return None
    for root, _, files in sorted(os.walk(base)):
        for cand in SCENE_ASSET_CANDIDATES:
            if cand in files:
                return os.path.join(root, cand)
    return None


@dataclass
class VLNEvalTaskSpec:
    """Per-episode task spec handed to the env backend (the reference's
    VLNEvalTaskCfg equivalent)."""

    path_key: str
    episode: Episode
    start_position: np.ndarray
    start_rotation: np.ndarray
    scene_asset: Optional[str]
    metric: MetricCfg
    max_step: int
    warm_up_step: int
    robot_name: str = "h1"
    robot_flash: bool = True
    extra: Dict[str, Any] = field(default_factory=dict)


def generate_vln_episodes(
    episodes: Sequence[Episode],
    task_cfg: TaskCfg,
    scene_data_dir: Optional[str] = None,
) -> List[VLNEvalTaskSpec]:
    """Build one task spec per episode (reference generate_vln_episode)."""
    specs: List[VLNEvalTaskSpec] = []
    for ep in episodes:
        asset = None
        if scene_data_dir:
            asset = load_scene_asset(scene_data_dir, ep.scene_id)
            if asset is None:
                continue  # reference skips episodes with missing scenes
        specs.append(VLNEvalTaskSpec(
            path_key=ep.path_key,
            episode=ep,
            start_position=np.asarray(ep.start_position, np.float64),
            start_rotation=np.asarray(ep.start_rotation, np.float64),
            scene_asset=asset,
            metric=task_cfg.metric_config,
            max_step=task_cfg.max_step,
            warm_up_step=task_cfg.warm_up_step,
            robot_name=task_cfg.robot_name,
            robot_flash=task_cfg.robot_flash,
        ))
    return specs
