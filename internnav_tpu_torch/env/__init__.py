"""Simulator-free evaluation environments of the port (copies of
internnav_tpu/env/: the registry, episodes, metrics, controllers, the
checkers, occupancy maps, VLN-PE task specs and the kinematic `FakeEnv`),
and the InternUtopia VLN-PE layer (`internutopia/`: the registered
"internutopia" env over `FakePhysicsVecEnv` or Isaac, the H1 loco
controller, the batched-protocol adapter). The registered "habitat" env is
`internnav_tpu_torch.habitat.env.HabitatEnv` (imported on its own, as in
the JAX package)."""

from internnav_tpu_torch.env.base import Env, env_registry
from internnav_tpu_torch.env.episodes import (
    Episode,
    ResumableEpisodeLoader,
    group_by_scene,
    load_r2r_episodes,
    shard_episodes,
)
from internnav_tpu_torch.env.fake_env import FakeEnv
from internnav_tpu_torch.env.internutopia.env import InternutopiaEnv
from internnav_tpu_torch.env.metrics import VLNPEMetrics, aggregate_metrics, ndtw, simplified_ndtw

__all__ = [
    "Env", "env_registry", "Episode", "ResumableEpisodeLoader",
    "group_by_scene", "load_r2r_episodes", "shard_episodes", "FakeEnv",
    "InternutopiaEnv",
    "VLNPEMetrics", "aggregate_metrics", "ndtw", "simplified_ndtw",
]
