"""Batched obs-list adapter over the internutopia 5-tuple protocol.

Wraps a vec env speaking the internutopia protocol (Isaac Sim in
production, FakePhysicsVecEnv in tests — both behind InternutopiaEnv)
into the obs-list protocol that VLNBatchedEvaluator/VLNPipelinedEvaluator
drive: ``reset()/step(List[int]) -> List[obs]`` where each obs carries
``path_key``/``done``, plus an ``episode_results`` list. One adapter per
cohort, each owning its episode share's env, is what lets the pipelined
multi-cohort evaluator run against real simulators instead of only the
fake kinematic env.

Reference parity: the per-slot FSM is the reference evaluator's macro-step
protocol (internnav/evaluator/vln_distributed_evaluator.py — runner_status
:19-25, warm_up :85-92, _transform_action_batch :106-126, the substep loop
env_step :158-182, and terminate_ops' result collection :184-266),
refactored out of the evaluator into an env adapter so the cohort
scheduler stays protocol-agnostic: the coroutine scheduler only ever sees
"batch in, obs out" and never blocks on physics substeps of a cohort it
isn't currently advancing.

Copy of internnav_tpu/env/internutopia/batch_adapter.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class _Status(enum.IntEnum):
    NORMAL = 0
    WARM_UP = 1
    TERMINATED = 3
    STOP = 4


class VLNPEBatchAdapter:
    """Batched obs-list facade over one internutopia-protocol vec env."""

    #: obs keys consumed by the FSM, stripped before the agent sees them
    #: (reference vln_distributed_evaluator.py IGNORE_OBS_ATTR)
    IGNORE_OBS_ATTR = ("finish_action", "current_pose", "render",
                       "fail_reason", "metrics")

    def __init__(self, env, robot_name: str, robot_flash: bool = True,
                 episodes: Optional[Sequence[Any]] = None,
                 rgb_hw: Sequence[int] = (256, 256)) -> None:
        self.env = env
        self.env_num = int(getattr(env, "env_num", 1))
        self.robot_name = robot_name
        self.robot_flash = bool(robot_flash)
        self.episodes = list(episodes if episodes is not None
                             else getattr(env, "episodes", []))
        self.rgb_hw = tuple(int(x) for x in rgb_hw)
        self.status = np.full((self.env_num,), _Status.WARM_UP, np.int64)
        self.episode_results: List[Dict[str, Any]] = []
        self._path_keys: List[Optional[str]] = [None] * self.env_num
        self._done: np.ndarray = np.zeros((self.env_num,), bool)
        #: last raw flat obs per slot that carried a real capture — partial
        #: resets must NOT replace live slots' frames with zero fills
        self._last_flat: List[Dict[str, Any]] = [{} for _ in range(self.env_num)]

    # ------------------------------------------------------------ protocol
    @property
    def is_running(self) -> bool:
        return not bool(np.all(self.status == _Status.TERMINATED))

    def close(self) -> None:
        self.env.close()

    def reset(self, env_ids: Optional[List[int]] = None):
        """Full reset runs the warm-up protocol inline (stand_still until
        the physics settles + first capture, reference :85-92); per-slot
        re-resets switch the slot to WARM_UP exactly as the reference's
        terminate_ops does (:235) — step() stand-stills it and flips it to
        NORMAL once its finish_action arrives (:194-197).

        The real InternUtopia vec env answers a partial reset with
        reset-envs-only lists positionally aligned to ``env_ids``
        (reference :234-240 assigns ``reset_infos[reset_env_ids] =
        new_reset_infos``); FakePhysicsVecEnv returns full-length lists.
        Both layouts are accepted: full-length (== env_num) is indexed by
        slot id, anything else positionally by env_ids order."""
        obs, infos = self.env.reset(env_ids)
        ids = list(range(self.env_num)) if env_ids is None else list(env_ids)
        fresh = env_ids is None
        slot_indexed = infos is not None and len(infos) == self.env_num
        for pos, i in enumerate(ids):
            if slot_indexed:
                info = infos[i]
            else:
                info = infos[pos] if infos and pos < len(infos) else None
            key = info.data.get("path_key") if info is not None else None
            if key:
                self._path_keys[i] = str(key)
                self.status[i] = _Status.WARM_UP
                self._done[i] = False
            else:
                self._path_keys[i] = None
                self.status[i] = _Status.TERMINATED
                self._done[i] = True
        if fresh:
            obs = self._warm_up()
            return self._to_obs_list(obs)
        # partial re-reset: the vec env's reset obs carries no capture
        # (Isaac renders only at macro-step finish). Keep every live
        # slot's last real frame and give the reset slots a fresh
        # side-effect-free capture where the backend can provide one.
        flat_src = self._flatten(obs) if obs is not None else []
        if len(flat_src) == self.env_num:
            flat = flat_src
        else:  # positional reset-only obs (real backend)
            flat = [self._last_flat[i] for i in range(self.env_num)]
            for pos, i in enumerate(ids):
                if pos < len(flat_src):
                    flat[i] = flat_src[pos]
        frames = (self.env.render_frames()
                  if hasattr(self.env, "render_frames") else None)
        merged = []
        for i, ob in enumerate(flat):
            if i in ids:
                if frames is not None and frames[i] is not None:
                    ob = dict(ob)
                    ob.update(frames[i])
                self._last_flat[i] = ob
                merged.append(ob)
            else:
                merged.append(self._last_flat[i] or ob)
        return self._to_obs_list([{self.robot_name: m} for m in merged])

    def _warm_up(self):
        live = self.status == _Status.WARM_UP
        obs = self.env.get_observation() if hasattr(self.env, "get_observation") \
            else self.env.get_observations()
        if not live.any():
            return obs
        still = [{self.robot_name: {"stand_still": []}}] * self.env_num
        while True:
            obs, _, _, _, _ = self.env.step(list(still))
            flat = self._flatten(obs)
            if all(bool(flat[i].get("finish_action"))
                   for i in range(self.env_num) if live[i]):
                break
        self.status[live] = _Status.NORMAL
        self._remember(self._flatten(obs))
        return obs

    def step(self, actions: Sequence[int]):
        """One macro-step: transform discrete ints to controller commands,
        substep the physics until every NORMAL env reports finish_action,
        then collect any finished episodes into ``episode_results``."""
        assert len(actions) == self.env_num, (len(actions), self.env_num)
        cmds = self._transform(actions)
        if not np.isin(self.status, (_Status.NORMAL, _Status.STOP,
                                     _Status.WARM_UP)).any():
            obs = self.env.get_observation() if hasattr(self.env, "get_observation") \
                else self.env.get_observations()
            return self._to_obs_list(obs)
        while True:
            obs, _, terminated, _, _ = self.env.step(list(cmds))
            flat = self._flatten(obs)
            finish = np.array([bool(ob.get("finish_action")) for ob in flat]) \
                | np.asarray(terminated, bool)
            normal = self.status == _Status.NORMAL
            if (normal.any() and finish[normal].all()) or finish.all():
                self.status[self.status == _Status.STOP] = _Status.NORMAL
                break
        # warm-up completion: freshly reset slots that stood still through
        # this macro-step and reported finish_action are now settled —
        # flip to NORMAL (reference terminate_ops :194-197); the evaluator
        # resets the agent's slot state when it sees warming_up drop.
        warmed = (self.status == _Status.WARM_UP) & finish
        self.status[warmed] = _Status.NORMAL
        # terminate_ops result collection (reference :194-211); the caller
        # (cohort scheduler) performs the re-reset via reset(done_ids)
        for i, (ob, term) in enumerate(zip(flat, terminated)):
            if self.status[i] == _Status.TERMINATED or self._done[i]:
                continue
            if term or ob.get("metrics"):
                m = dict(ob.get("metrics") or {})
                m.setdefault("fail_reason", ob.get("fail_reason", ""))
                m.setdefault("path_key", self._path_keys[i])
                self.episode_results.append(m)
                self._done[i] = True
        self._remember(flat)
        return self._to_obs_list(obs)

    # ------------------------------------------------------------ internals
    def _remember(self, flat: List[Dict[str, Any]]) -> None:
        for i, ob in enumerate(flat):
            if ob.get("rgb") is not None:
                self._last_flat[i] = ob

    def _transform(self, actions: Sequence[int]) -> List[Dict[str, Any]]:
        """Discrete ints -> controller command dicts (reference
        _transform_action_batch :106-126). 0=stop, -1=stand_still,
        1..3=move; WARM_UP/TERMINATED slots are forced to stand_still."""
        cmds: List[Dict[str, Any]] = []
        move = f"move_by_{'flash' if self.robot_flash else 'discrete'}"
        for i, a in enumerate(actions):
            if self.status[i] in (_Status.WARM_UP, _Status.TERMINATED) \
                    or self._done[i]:
                cmds.append({self.robot_name: {"stand_still": []}})
                continue
            a = int(a)
            if a == 0:
                self.status[i] = _Status.STOP
                cmds.append({self.robot_name: {"stop": []}})
            elif a == -1:
                cmds.append({self.robot_name: {"stand_still": []}})
            else:
                cmds.append({self.robot_name: {move: [a]}})
        return cmds

    def _flatten(self, obs_list) -> List[Dict[str, Any]]:
        out = []
        for ob in obs_list:
            if ob is None:
                out.append({})
            else:
                out.append(ob.get(self.robot_name, ob))
        return out

    def _to_obs_list(self, obs_raw) -> List[Optional[Dict[str, Any]]]:
        """Strip FSM-internal keys, attach path_key/done, and guarantee
        static rgb/depth shapes (zero frames for slots whose tick carried
        no capture) so the batched policy sees one shape of frame batch."""
        flat = self._flatten(obs_raw)
        out: List[Optional[Dict[str, Any]]] = []
        for i, ob in enumerate(flat):
            if self._path_keys[i] is None:  # exhausted slot, like FakeEnv
                out.append(None)
                continue
            o = {k: v for k, v in ob.items() if k not in self.IGNORE_OBS_ATTR}
            if "rgb" not in o:
                o["rgb"] = np.zeros(self.rgb_hw + (3,), np.uint8)
            if "depth" not in o:
                o["depth"] = np.zeros(self.rgb_hw + (1,), np.float32)
            o["path_key"] = self._path_keys[i]
            o["done"] = bool(self._done[i])
            # warm-up slots are not ready for the agent: the reference
            # substitutes fake_obs for them (:130-137) and resets the
            # agent's slot when warm-up finishes (:194-197)
            o["warming_up"] = bool(self.status[i] == _Status.WARM_UP)
            out.append(o)
        return out
