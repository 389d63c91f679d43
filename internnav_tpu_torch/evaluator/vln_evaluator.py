"""Batched VLN evaluator over vectorized envs.

Port of internnav_tpu/evaluator/vln_evaluator.py: the same loop, with the
rank and world size from `torch.distributed` (`base.get_rank_world`).
The env it builds itself is FakeEnv: without an `env=` any other
env_type raises (VLN-PE runs through eval_type "vln_pe", or the pipelined
evaluator's internutopia cohorts, which hand their env in; Habitat has
evaluators of its own, `habitat/evaluator.py`), where the original would
run the fake backend in its place.

Reference parity: internnav/evaluator/vln_distributed_evaluator.py — the
per-env FSM (runner_status NORMAL/TERMINATED, :19-25), fake-obs masking for
inactive envs (get_action:128-148), terminate_ops saving results + re-reset
(:184-266), dataset-exhaustion detection, and the resume store.

The policy batch always has env_num slots: finished or terminated slots
are fed a zero observation and their action is discarded.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from internnav_tpu_torch.configs.evaluator import EvalCfg
from internnav_tpu_torch.env.episodes import (
    Episode,
    ResumableEpisodeLoader,
    group_by_scene,
    load_r2r_episodes,
    shard_episodes,
)
from internnav_tpu_torch.env.fake_env import FakeEnv
from internnav_tpu_torch.evaluator.base import Evaluator, get_rank_world
from internnav_tpu_torch.evaluator.utils.data_collector import EpisodeResultStore
from internnav_tpu_torch.utils.logging import ProgressLogger


@Evaluator.register("vln_batched")
class VLNBatchedEvaluator(Evaluator):
    def __init__(self, cfg: EvalCfg, episodes: Optional[List[Episode]] = None, **kwargs):
        rank, world = get_rank_world()
        self.store = EpisodeResultStore(root=f"{cfg.output_dir}/resume", rank=rank)
        if episodes is None:
            episodes = self._load_episodes(cfg)
        episodes = shard_episodes(group_by_scene(episodes), rank, world)
        loader = ResumableEpisodeLoader(episodes, store=self.store,
                                        retry_list=cfg.dataset.retry_list)
        pending = loader.pending()
        self._resumed_done = [e for e in episodes if e not in pending]
        env = kwargs.pop("env", None)
        if env is None:
            if cfg.env.env_type != "fake":
                raise NotImplementedError(
                    f"env_type {cfg.env.env_type!r}: this evaluator builds env_type 'fake' "
                    "alone (VLN-PE runs through eval_type 'vln_pe' or 'vln_pipelined'; "
                    "Habitat through eval_type 'habitat_vln', 'habitat_default' or "
                    "'habitat_dialog')")
            env = FakeEnv(cfg.env, cfg.task, episodes=pending)
        super().__init__(cfg, env=env, **kwargs)
        self.progress = ProgressLogger(name="eval_progress", log_dir=cfg.output_dir)
        self._last_obs: List[Optional[Dict[str, Any]]] = [None] * self.env.env_num

    @staticmethod
    def _load_episodes(cfg: EvalCfg) -> List[Episode]:
        d = cfg.dataset
        if d.base_data_dir:
            eps: List[Episode] = []
            for split in d.split_data_types:
                for ext in (".json.gz", ".json"):
                    path = f"{d.base_data_dir}/{split}/{split}{ext}"
                    import os

                    if os.path.exists(path):
                        eps.extend(load_r2r_episodes(path, split, d.filter_stairs, d.max_episodes))
                        break
            return eps
        raise ValueError("no episode source: set dataset.base_data_dir or pass episodes=")

    # ----------------------------------------------------------------- loop
    def _fake_obs(self) -> Dict[str, Any]:
        hw = tuple(self.env.rgb_hw) if hasattr(self.env, "rgb_hw") else (256, 256)
        return {
            "rgb": np.zeros(hw + (3,), np.uint8),
            "depth": np.zeros(hw + (1,), np.float32),
            "instruction": np.zeros((200,), np.int32),
        }

    def eval_action(self) -> List[Dict[str, Any]]:
        env = self.env
        from internnav_tpu_torch.evaluator.utils.latency import ActionLatencyTracker

        latency = ActionLatencyTracker()
        obs_list = env.reset()
        latency.start()
        for o in obs_list:
            if o is not None:
                self.progress.start(o["path_key"])
        results: List[Dict[str, Any]] = []
        prev_count = 0
        while env.is_running:
            batch_obs, live_idx = [], []
            warming = {i for i, o in enumerate(obs_list)
                       if o is not None and o.get("warming_up", False)}
            for i, o in enumerate(obs_list):
                if o is None or o.get("done", False) or i in warming:
                    # warm-up slots see fake obs like the reference
                    # (vln_distributed_evaluator.py:130-137); the env
                    # adapter forces their action to stand_still
                    batch_obs.append(self._fake_obs())
                else:
                    batch_obs.append(o)
                    live_idx.append(i)
            if not live_idx and not warming:
                break
            agent_out = self.agent.step(batch_obs)
            actions = [int(a["action"][0]) for a in agent_out]
            obs_list = env.step(actions)
            latency.mark(len(live_idx))
            # agent slot state polluted by warm-up fake obs: reset once
            # warm-up completes (reference terminate_ops :194-197)
            warmed = [i for i in warming
                      if obs_list[i] is not None
                      and not obs_list[i].get("warming_up", False)
                      and not obs_list[i].get("done", False)]
            if warmed:
                self.agent.reset(warmed)
            for i in live_idx:
                o = obs_list[i]
                if o is not None:
                    self.progress.step(o["path_key"])

            # terminate_ops: collect finished episodes, reset slots
            new_results = env.episode_results[prev_count:]
            if new_results:
                done_ids = [
                    i for i, o in enumerate(obs_list) if o is not None and o.get("done", False)
                ]
                for rec in new_results:
                    key = str(rec.get("path_key") or rec.get("episode_id", ""))
                    self.store.save_eval_result(
                        key=key,
                        fail_reason=rec.get("fail_reason", ""),
                        info=rec,
                    )
                    self.progress.end(key, "success" if rec.get("success") else
                                      (rec.get("fail_reason") or "fail"))
                results.extend(new_results)
                prev_count += len(new_results)
                if done_ids:
                    self.agent.reset(done_ids)
                    obs_list = env.reset(done_ids)
                    for i in done_ids:
                        o = obs_list[i]
                        if o is not None:
                            self.progress.start(o["path_key"])
        # resumed episodes' stored metrics count toward the aggregate
        for rec in self.store.records():
            info = rec.get("info") or {}
            if info and info.get("episode_id") not in {r.get("episode_id") for r in results}:
                results.append(info)
        self.progress.report()
        self.latency_summary = latency.summary()
        return results

    def calc_metrics(self, per_episode: List[Dict[str, Any]]) -> Dict[str, float]:
        metrics = super().calc_metrics(per_episode)
        metrics.update(getattr(self, "latency_summary", None) or {})
        return metrics

