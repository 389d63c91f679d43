"""HabitatEnv — the registered habitat backend.

Reference parity: internnav/env/habitat_env.py:9-115 — scene-grouped
episode list sharded rank::world_size (:72), resume-skip of episodes
already in progress.json (:56-64), manual current_episode advance on reset
(:87-92), and step() returning (obs, reward, done, info=get_metrics()).

The underlying simulator is any HabitatSimLike: the real habitat.Env via
HabitatSimAdapter (import-guarded), the kinematic FakeSim, or an injected
sim (env_settings['sim']) — which is how the golden-tape contract test
drives this exact consumer path without habitat installed.

Copy of internnav_tpu/habitat/env.py over the port's env registry and
episodes (held to the JAX class by tests/test_torch_habitat.py).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from internnav_tpu_torch.configs.evaluator import EnvCfg, TaskCfg
from internnav_tpu_torch.env.base import Env
from internnav_tpu_torch.env.episodes import (
    Episode,
    group_by_scene,
    load_r2r_episodes,
    shard_episodes,
)


@Env.register("habitat")
class HabitatEnv(Env):
    def __init__(self, env_cfg: EnvCfg, task_cfg: Optional[TaskCfg] = None,
                 episodes: Optional[List[Episode]] = None, sim=None):
        super().__init__(env_cfg, task_cfg)
        s = env_cfg.env_settings
        if episodes is None:
            episodes = self._load_episodes(s)
        episodes = shard_episodes(group_by_scene(episodes),
                                  s.get("rank", 0), s.get("world_size", 1))
        done = self._done_ids(s.get("progress_path"))
        self.episodes = [e for e in episodes if e.episode_id not in done]
        self._idx = -1
        self.sim = sim or s.get("sim")
        if self.sim is None:
            from internnav_tpu_torch.habitat.sim_adapter import FakeSim, HabitatSimAdapter

            if s.get("backend", "habitat") == "fake":
                self.sim = FakeSim(rgb_hw=tuple(self.task_cfg.camera_resolution))
            else:
                try:
                    import habitat  # noqa: F401
                except ImportError as e:
                    raise RuntimeError(
                        "habitat is not installed; set env_settings"
                        "['backend']='fake' or inject env_settings['sim']"
                    ) from e
                self.sim = HabitatSimAdapter(_CfgShim(env_cfg))
        self.current_episode: Optional[Episode] = None

    @staticmethod
    def _load_episodes(s: Dict[str, Any]) -> List[Episode]:
        ds = s.get("dataset", {})
        base = ds.get("base_data_dir")
        if not base:
            return []
        eps: List[Episode] = []
        for split in ds.get("split_data_types", ["val_unseen"]):
            for ext in (".json.gz", ".json"):
                p = f"{base}/{split}/{split}{ext}"
                if os.path.exists(p):
                    eps.extend(load_r2r_episodes(p, split))
                    break
        return eps

    @staticmethod
    def _done_ids(progress_path: Optional[str]) -> set:
        done = set()
        if progress_path and os.path.exists(progress_path):
            with open(progress_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        try:
                            done.add(str(json.loads(line)["episode_id"]))
                        except Exception:
                            continue
        return done

    # ------------------------------------------------------------------ api
    def reset(self, env_ids=None) -> Optional[Dict[str, Any]]:
        self._idx += 1
        if self._idx >= len(self.episodes):
            self.current_episode = None
            self._is_running = False
            return None
        self.current_episode = self.episodes[self._idx]
        return self.sim.reset(self.current_episode)

    def step(self, action):
        """→ (obs, reward, done, info) like the reference (:95-108)."""
        a = action[0] if isinstance(action, (list, tuple)) else action
        obs = self.sim.step(int(a))
        done = bool(self.sim.episode_over)
        info = self.get_info()
        return obs, 0.0, done, info

    def get_observation(self):
        return getattr(self.sim, "_obs", None)

    def get_info(self) -> Dict[str, Any]:
        if hasattr(self.sim, "get_metrics"):
            return self.sim.get_metrics()
        return {}

    def close(self) -> None:
        if hasattr(self.sim, "close"):
            self.sim.close()
        self._is_running = False


class _CfgShim:
    """HabitatSimAdapter reads cfg.env.env_settings; wrap a bare EnvCfg."""

    def __init__(self, env_cfg: EnvCfg):
        self.env = env_cfg
