"""Simulator-free evaluation environments of the port (copies of
internnav_tpu/env/: the registry, episodes, metrics, controllers and the
kinematic `FakeEnv`). The registered "habitat" env is
`internnav_tpu_torch.habitat.env.HabitatEnv` (imported on its own, as in
the JAX package); the InternUtopia adapters are not ported yet (ROADMAP
§1 item 7f)."""

from internnav_tpu_torch.env.base import Env, env_registry
from internnav_tpu_torch.env.episodes import (
    Episode,
    ResumableEpisodeLoader,
    group_by_scene,
    load_r2r_episodes,
    shard_episodes,
)
from internnav_tpu_torch.env.fake_env import FakeEnv
from internnav_tpu_torch.env.metrics import VLNPEMetrics, aggregate_metrics, ndtw, simplified_ndtw

__all__ = [
    "Env", "env_registry", "Episode", "ResumableEpisodeLoader",
    "group_by_scene", "load_r2r_episodes", "shard_episodes", "FakeEnv",
    "VLNPEMetrics", "aggregate_metrics", "ndtw", "simplified_ndtw",
]
