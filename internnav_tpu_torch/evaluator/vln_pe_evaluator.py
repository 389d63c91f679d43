"""VLN-PE evaluator — the Isaac/InternUtopia physics-protocol FSM.

Reference parity: internnav/evaluator/vln_distributed_evaluator.py — per-env
runner_status FSM (:19-25), warm_up loop (:85-92), fake-obs masking +
agent step + action transform (get_action :128-148,
_transform_action_batch :106-126), the substep loop that steps the sim
until every NORMAL env reports finish_action (env_step :158-182), and
terminate_ops (result store, progress logging, slot re-reset, dataset
exhaustion, :184-266).

Runs against any vec env speaking the internutopia 5-tuple protocol —
Isaac Sim in production, FakePhysicsVecEnv in tests (both behind
InternutopiaEnv). The agent sees a batch of env_num observations every
macro step, inactive slots filled with a fake observation.

Copy of internnav_tpu/evaluator/vln_pe_evaluator.py,
kept in the port so that it imports nothing of the JAX package, with one
deliberate difference: a slot re-reset by terminate_ops starts its new
episode from the new episode's observation where the env can render one
outside the macro-step protocol (`render_frames`, which FakePhysicsVecEnv
has): the reset observation with that frame and the new instruction. The
JAX evaluator hands the agent the previous episode's last observation
there (its frame and instruction; after a stop, no frame at all, on which
the InternVLA-N1 agent raises KeyError). Agents that ignore their
observations (the "simple" agent) act the same in both.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

import numpy as np

from internnav_tpu_torch.configs.evaluator import EvalCfg
from internnav_tpu_torch.env.episodes import (
    load_r2r_episodes,
    shard_episodes,
)
from internnav_tpu_torch.env.internutopia.env import InternutopiaEnv
from internnav_tpu_torch.evaluator.base import Evaluator, get_rank_world
from internnav_tpu_torch.evaluator.utils.data_collector import EpisodeResultStore
from internnav_tpu_torch.utils.logging import ProgressLogger


class RunnerStatus(enum.IntEnum):
    NORMAL = 0
    WARM_UP = 1
    NOT_RESET = 2
    TERMINATED = 3
    STOP = 4


@Evaluator.register("vln_pe")
class VLNPEEvaluator(Evaluator):
    def __init__(self, cfg: EvalCfg, episodes=None, **kwargs):
        rank, world = get_rank_world()
        self.store = EpisodeResultStore(root=f"{cfg.output_dir}/resume", rank=rank)
        env = kwargs.pop("env", None)
        if env is None:
            if episodes is None:
                episodes = self._load_episodes(cfg, rank, world)
            from internnav_tpu_torch.env.episodes import ResumableEpisodeLoader

            pending = ResumableEpisodeLoader(
                episodes, store=self.store,
                retry_list=cfg.dataset.retry_list).pending()
            env = InternutopiaEnv(cfg.env, cfg.task, episodes=pending)
        super().__init__(cfg, env=env, **kwargs)
        self.env_num = self.env.env_num if hasattr(self.env, "env_num") else cfg.env.env_num
        self.robot_name = cfg.task.robot_name
        self.robot_flash = cfg.task.robot_flash
        self.progress = ProgressLogger(name="eval_progress", log_dir=cfg.output_dir)
        self.runner_status = np.full((self.env_num,), RunnerStatus.WARM_UP,
                                     dtype=np.int64)
        self.fake_obs = self._fake_obs(cfg)
        self.results: List[Dict[str, Any]] = []
        #: slot -> the first observation of the episode terminate_ops
        #: just reset it to (see the module doc)
        self._fresh: Dict[int, Dict[str, Any]] = {}

    @staticmethod
    def _load_episodes(cfg: EvalCfg, rank: int, world: int):
        d = cfg.dataset
        eps = []
        import os

        for split in d.split_data_types:
            for ext in (".json.gz", ".json"):
                p = f"{d.base_data_dir}/{split}/{split}{ext}"
                if os.path.exists(p):
                    eps.extend(load_r2r_episodes(p, split, d.filter_stairs,
                                                 d.max_episodes))
                    break
        return shard_episodes(eps, rank, world)

    # ----------------------------------------------------------------- obs
    IGNORE_OBS_ATTR = ("finish_action", "current_pose", "render",
                       "fail_reason", "metrics")

    def _fake_obs(self, cfg: EvalCfg) -> Dict[str, Any]:
        hw = tuple(cfg.task.camera_resolution)
        return {
            "rgb": np.zeros(hw + (3,), np.uint8),
            "depth": np.zeros(hw + (1,), np.float32),
            "instruction": np.zeros((200,), np.int32),
            "instruction_text": "",
            "globalgps": np.zeros(3),
            "globalrotation": np.array([1.0, 0, 0, 0]),
        }

    def _flatten(self, obs_list) -> List[Dict[str, Any]]:
        """Unwrap robot-name keying; None slots get the fake obs."""
        out = []
        for ob in obs_list:
            if ob is None:
                out.append(dict(self.fake_obs))
            else:
                out.append(ob.get(self.robot_name, ob))
        return out

    def _strip(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return [{k: v for k, v in ob.items() if k not in self.IGNORE_OBS_ATTR}
                for ob in obs]

    # -------------------------------------------------------------- actions
    def _transform_action_batch(self, actions: List[Dict], flash: bool):
        """Agent output -> controller command dicts (reference :106-126)."""
        out = []
        for action in actions:
            ideal = bool(action.get("ideal_flag", False))
            if flash:
                assert ideal, "flash mode requires ideal (discrete) actions"
            if not ideal:
                out.append({self.robot_name:
                            {"vln_dp_move_by_speed": action["action"][0]}})
                continue
            a = action["action"]
            a0 = a[0] if isinstance(a, (list, tuple, np.ndarray)) else a
            a0 = a0[0] if isinstance(a0, (list, tuple, np.ndarray)) else a0
            if a0 == 0:
                out.append({self.robot_name: {"stop": []}})
            elif a0 == -1:
                out.append({self.robot_name: {"stand_still": []}})
            else:
                move = f"move_by_{'flash' if flash else 'discrete'}"
                out.append({self.robot_name: {move: [int(a0)]}})
        return out

    def get_action(self, obs_list):
        obs = self._flatten(obs_list)
        masked = []
        for i, ob in enumerate(obs):
            if self.runner_status[i] in (RunnerStatus.WARM_UP, RunnerStatus.TERMINATED):
                masked.append(dict(self.fake_obs))
            else:
                masked.append(ob)
        masked = self._strip(masked)
        if np.all(self.runner_status == RunnerStatus.WARM_UP):
            actions = [{self.robot_name: {"stand_still": []}}] * self.env_num
            return actions
        agent_out = self.agent.step(masked)
        actions = self._transform_action_batch(agent_out, self.robot_flash)
        for i in range(self.env_num):
            if self.runner_status[i] == RunnerStatus.WARM_UP:
                actions[i] = {self.robot_name: {"stand_still": []}}
            elif self.runner_status[i] == RunnerStatus.TERMINATED:
                actions[i] = {self.robot_name: {"stand_still": []}}
        return actions

    # ------------------------------------------------------------ sim loop
    def warm_up(self):
        """stand_still all envs until the physics settles + first capture."""
        live = self.runner_status == RunnerStatus.WARM_UP
        if not live.any():
            return self.env.get_observations()
        while True:
            obs, _, _, _, _ = self.env.step(
                [{self.robot_name: {"stand_still": []}}] * self.env_num)
            flat = self._flatten(obs)
            if all(bool(flat[i].get("finish_action"))
                   for i in range(self.env_num) if live[i]):
                break
        self.runner_status[live] = RunnerStatus.NORMAL
        return obs

    def env_step(self, actions):
        """Step physics until every NORMAL env reports finish_action
        (macro-step atomicity; reference env_step :158-182)."""
        if not (self.runner_status == RunnerStatus.NORMAL).any():
            return self.env.get_observations(), [False] * self.env_num
        for i, a in enumerate(actions):
            if (self.runner_status[i] == RunnerStatus.NORMAL
                    and "stop" in a.get(self.robot_name, {})):
                self.runner_status[i] = RunnerStatus.STOP
        while True:
            obs, _, terminated, _, _ = self.env.step(list(actions))
            flat = self._flatten(obs)
            finish = np.array([bool(ob.get("finish_action")) for ob in flat]) | \
                np.asarray(terminated, bool)
            normal = self.runner_status == RunnerStatus.NORMAL
            if (normal.any() and finish[normal].all()) or finish.all():
                self.runner_status[self.runner_status == RunnerStatus.STOP] = \
                    RunnerStatus.NORMAL
                break
        return obs, terminated

    def terminate_ops(self, obs_list, terminated) -> bool:
        """Collect finished episodes, re-reset slots, detect exhaustion.
        Returns True when every env is TERMINATED (eval over)."""
        flat = self._flatten(obs_list)
        reset_ids = []
        for i, (ob, term) in enumerate(zip(flat, terminated)):
            if self.runner_status[i] == RunnerStatus.TERMINATED:
                continue
            if term or ob.get("metrics"):
                m = dict(ob.get("metrics") or {})
                key = str(m.get("path_key") or m.get("episode_id") or i)
                m.setdefault("fail_reason", ob.get("fail_reason", ""))
                self.store.save_eval_result(
                    key=key, fail_reason=m.get("fail_reason", ""), info=m)
                self.progress.end(key, "success" if m.get("success")
                                  else (m.get("fail_reason") or "fail"))
                self.results.append(m)
                reset_ids.append(i)
        if reset_ids:
            self.agent.reset(reset_ids)
            obs, infos = self.env.reset(reset_ids)
            render = getattr(self.env, "render_frames", None)
            frames = render() if render is not None else None
            flat_new = self._flatten(obs)
            for i in reset_ids:
                info = infos[i]
                if info is not None and info.data.get("path_key"):
                    self.progress.start(info.data["path_key"])
                    self.runner_status[i] = RunnerStatus.NORMAL
                    if frames is not None and frames[i] is not None:
                        ins = info.data.get("instruction") or {}
                        self._fresh[i] = {
                            **flat_new[i], **frames[i],
                            "instruction": ins.get("instruction_text", ""),
                            "instruction_tokens": ins.get("instruction_tokens")}
                else:
                    self.runner_status[i] = RunnerStatus.TERMINATED
        return bool(np.all(self.runner_status == RunnerStatus.TERMINATED))

    # ------------------------------------------------------------ main loop
    def eval_action(self) -> List[Dict[str, Any]]:
        obs, infos = self.env.reset()
        for i, info in enumerate(infos):
            if info is not None and info.data.get("path_key"):
                self.progress.start(info.data["path_key"])
            else:
                self.runner_status[i] = RunnerStatus.TERMINATED
        if np.all(self.runner_status == RunnerStatus.TERMINATED):
            self.progress.report()
            return self._with_resumed([])
        obs = self.warm_up()
        while True:
            actions = self.get_action(obs)
            obs, terminated = self.env_step(actions)
            for i, ob in enumerate(self._flatten(obs)):
                if self.runner_status[i] == RunnerStatus.NORMAL and ob.get("finish_action"):
                    key = ob.get("metrics", {}).get("path_key") if ob.get("metrics") else None
                    self.progress.step(key or str(i))
            if self.terminate_ops(obs, terminated):
                break
            if self._fresh:
                obs = list(obs)
                for i, ob in self._fresh.items():
                    obs[i] = {self.robot_name: ob}
                self._fresh.clear()
        self.progress.report()
        return self._with_resumed(self.results)

    def _with_resumed(self, results: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        seen = {str(r.get("path_key") or r.get("episode_id")) for r in results}
        for rec in self.store.records():
            info = rec.get("info") or {}
            key = str(info.get("path_key") or info.get("episode_id"))
            if info and key not in seen:
                results.append(info)
                seen.add(key)
        return results
