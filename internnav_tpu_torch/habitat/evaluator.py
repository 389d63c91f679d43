"""VLN-CE evaluator (Habitat backend, sim-agnostic core).

Reference parity: internnav/habitat_extensions/vln/habitat_vln_evaluator.py
(HabitatVLNEvaluator:67-945) — two eval modes:
- dual_system (:262-629): per step, depth filter/scale; the look-down
  protocol (LOOKDOWN x2 → capture → LOOKUP x2, :349-368) captures a
  downward RGB-D for System-1; S2 generate → pixel-goal (generate_latents
  + generate_traj + traj_to_actions, ≤ MAX_LOCAL_STEPS=4 per S1 call,
  MAX_STEPS=8 budget per S2 plan) vs action-sequence branch; per-episode
  metrics appended to progress.json with resume (:244-260);
- system2 (:631-945): S2 emits a pixel goal, unprojected to world GPS with
  the 30°-pitch camera TF and snapped to the navmesh, then a
  ShortestPathFollower walks toward it under the same budget.

habitat-sim is not installed in this environment; the evaluator takes any
sim with the `HabitatSimLike` duck type (reset/step/observations/metrics)
— `habitat.Env` satisfies it through the thin adapter at the bottom, and
the kinematic FakeSim in tests drives the same code paths.

Port of internnav_tpu/habitat/evaluator.py, the same loops over the port's
policy: `s2_step` (the fused System-2 step on the card) and
`s1_step_latent`, whose System-1 noise comes from the policy's
torch.Generator. The agent the evaluator builds from cfg.agent (when no
policy is handed in) is the port's: "internvla_n1" loads its policy on the
card (`agent/internvla_n1_agent._build_n1_policy`), "dialog" builds its
own (`dialog/dialog_agent.py`). Without sim= the evaluator needs habitat
and raises the JAX package's ImportError where it is not installed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from internnav_tpu_torch.dialog.dialog_agent import pixel_to_gps
from internnav_tpu_torch.env.episodes import Episode, shard_episodes
from internnav_tpu_torch.evaluator.base import Evaluator
from internnav_tpu_torch.habitat.measures import compute_all
from internnav_tpu_torch.model.utils.vln_utils import traj_to_actions

LOOKDOWN, LOOKUP = 5, 6
MAX_STEPS_PER_PLAN = 8
MAX_LOCAL_STEPS = 4


class HabitatSimLike(Protocol):
    def reset(self, episode: Episode) -> Dict[str, Any]: ...
    def step(self, action: int) -> Dict[str, Any]: ...
    @property
    def position(self) -> np.ndarray: ...
    @property
    def episode_over(self) -> bool: ...


def preprocess_depth(depth: np.ndarray, scale: float = 10.0,
                     clip_m: float = 5.0) -> np.ndarray:
    """Reference depth filtering (:326-328): scale to metric, clamp, zero
    invalid."""
    d = np.asarray(depth, np.float32) * scale
    d[~np.isfinite(d)] = 0.0
    return np.clip(d, 0.0, clip_m)


@Evaluator.register("habitat_vln")
class HabitatVLNEvaluator(Evaluator):
    def __init__(self, cfg, sim: Optional[HabitatSimLike] = None,
                 episodes: Optional[List[Episode]] = None, policy=None, **kwargs):
        self.mode = cfg.eval_settings.get("mode", "dual_system")  # dual_system | system2
        self.sim = sim if sim is not None else _build_habitat_sim(cfg)
        eps = episodes if episodes is not None else []
        self.episodes = shard_episodes(eps, *self._rank_world())
        self.policy = policy
        self.progress_path = os.path.join(cfg.output_dir, "progress.json")
        kwargs.setdefault("env", _NullEnv())
        super().__init__(cfg, **kwargs)
        if self.policy is None and hasattr(self.agent, "policy"):
            self.policy = self.agent.policy

    @staticmethod
    def _rank_world():
        from internnav_tpu_torch.evaluator.base import get_rank_world

        return get_rank_world()

    # ---------------------------------------------------------------- resume
    def _done_episode_ids(self) -> set:
        done = set()
        if os.path.exists(self.progress_path):
            with open(self.progress_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        try:
                            done.add(str(json.loads(line)["episode_id"]))
                        except Exception:
                            continue
        return done

    def _append_progress(self, rec: Dict[str, Any]) -> None:
        os.makedirs(os.path.dirname(self.progress_path) or ".", exist_ok=True)
        with open(self.progress_path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")

    # ------------------------------------------------------------- main loop
    def eval_action(self) -> List[Dict[str, Any]]:
        done = self._done_episode_ids()
        results: List[Dict[str, Any]] = []
        for ep in self.episodes:
            if ep.episode_id in done:
                continue
            if self.mode == "system2":
                rec = self._run_episode_system2(ep)
            else:
                rec = self._run_episode_dual(ep)
            rec["episode_id"] = ep.episode_id
            rec["split"] = ep.split
            self._append_progress(rec)
            results.append(rec)
        # resumed records still count toward aggregation
        if os.path.exists(self.progress_path):
            seen = {r["episode_id"] for r in results}
            with open(self.progress_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    if str(rec.get("episode_id")) not in seen:
                        results.append(rec)
        return results

    # ------------------------------------------------------------ dual system
    def _capture_lookdown(self, obs: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """LOOKDOWN x2 → capture → LOOKUP x2 (reference :349-368)."""
        self.sim.step(LOOKDOWN)
        down = self.sim.step(LOOKDOWN)
        self.sim.step(LOOKUP)
        obs = self.sim.step(LOOKUP)
        return down, obs

    def _run_episode_dual(self, ep: Episode) -> Dict[str, Any]:
        obs = self.sim.reset(ep)
        self.policy.reset()
        trajectory = [np.asarray(self.sim.position)]
        max_steps = self.cfg.task.max_step
        steps = 0
        while steps < max_steps and not self.sim.episode_over:
            down_obs, obs = self._capture_lookdown(obs)
            s2 = self.policy.s2_step(np.asarray(obs["rgb"]), ep.instruction_text)
            budget = MAX_STEPS_PER_PLAN
            if s2.output_latent is not None:
                while budget > 0 and steps < max_steps and not self.sim.episode_over:
                    rgb2 = np.stack([np.asarray(down_obs["rgb"]),
                                     np.asarray(obs["rgb"])])[None]
                    depth2 = None
                    if "depth" in obs:
                        d = preprocess_depth(obs["depth"])
                        dd = preprocess_depth(down_obs.get("depth", obs["depth"]))
                        if d.ndim == 2:
                            d, dd = d[..., None], dd[..., None]
                        depth2 = np.stack([dd, d])[None]
                    s1 = self.policy.s1_step_latent(rgb2, depth2, s2.output_latent)
                    acts = s1.idx[:MAX_LOCAL_STEPS] or [0]
                    for a in acts:
                        if steps >= max_steps or self.sim.episode_over or budget <= 0:
                            break
                        obs = self.sim.step(a)
                        trajectory.append(np.asarray(self.sim.position))
                        steps += 1
                        budget -= 1
                        if a == 0:
                            break
                    if acts and acts[-1] == 0:
                        break
            elif s2.output_action:
                for a in s2.output_action[:budget]:
                    if steps >= max_steps or self.sim.episode_over:
                        break
                    obs = self.sim.step(a)
                    trajectory.append(np.asarray(self.sim.position))
                    steps += 1
                    if a == 0:
                        break
                if 0 in s2.output_action[:budget]:
                    break
            else:
                break
        return compute_all(np.asarray(trajectory), ep.reference_path,
                           ep.geodesic_distance,
                           self.cfg.task.metric_config.success_distance)

    # --------------------------------------------------------------- system2
    def _run_episode_system2(self, ep: Episode) -> Dict[str, Any]:
        """S2 + shortest-path-follower mode (:631-945): pixel goal → GPS →
        follower steps (the sim must provide `follow_toward(gps) -> action`;
        a greedy kinematic follower is the fallback)."""
        obs = self.sim.reset(ep)
        self.policy.reset()
        trajectory = [np.asarray(self.sim.position)]
        max_steps = self.cfg.task.max_step
        steps = 0
        while steps < max_steps and not self.sim.episode_over:
            s2 = self.policy.s2_step(np.asarray(obs["rgb"]), ep.instruction_text)
            if s2.output_pixel is not None and "depth" in obs:
                depth = preprocess_depth(obs["depth"])
                h, w = depth.shape[:2]
                u, v = np.clip(int(s2.output_pixel[0]), 0, w - 1), \
                    np.clip(int(s2.output_pixel[1]), 0, h - 1)
                d = float(depth[v, u]) if depth.ndim == 2 else float(depth[v, u, 0])
                pose = [*np.asarray(self.sim.position)[:2],
                        float(getattr(self.sim, "yaw", 0.0))]
                gps = pixel_to_gps((u, v), max(d, 0.1), (h, w), 90.0, pose)
                for _ in range(MAX_STEPS_PER_PLAN):
                    if steps >= max_steps or self.sim.episode_over:
                        break
                    a = self._follower_action(gps[:2])
                    obs = self.sim.step(a)
                    trajectory.append(np.asarray(self.sim.position))
                    steps += 1
                    if a == 0:
                        break
            elif s2.output_action:
                for a in s2.output_action[:MAX_STEPS_PER_PLAN]:
                    if steps >= max_steps or self.sim.episode_over:
                        break
                    obs = self.sim.step(a)
                    trajectory.append(np.asarray(self.sim.position))
                    steps += 1
                    if a == 0:
                        break
                if 0 in s2.output_action[:MAX_STEPS_PER_PLAN]:
                    break
            else:
                break
        return compute_all(np.asarray(trajectory), ep.reference_path,
                           ep.geodesic_distance,
                           self.cfg.task.metric_config.success_distance)

    def _follower_action(self, goal_xy) -> int:
        """ShortestPathFollower stand-in: greedy turn-then-forward toward
        the GPS goal (habitat's follower when available)."""
        if hasattr(self.sim, "follow_toward"):
            return self.sim.follow_toward(goal_xy)
        pos = np.asarray(self.sim.position)[:2]
        yaw = float(getattr(self.sim, "yaw", 0.0))
        d = np.asarray(goal_xy) - pos
        if np.linalg.norm(d) < 0.25:
            return 0
        heading = (np.arctan2(d[1], d[0]) - yaw + np.pi) % (2 * np.pi) - np.pi
        if heading > np.deg2rad(15):
            return 2
        if heading < -np.deg2rad(15):
            return 3
        return 1


class _NullEnv:
    """Evaluator base expects an env attr; the habitat sim replaces it."""

    is_running = True

    def close(self):
        pass


def _build_habitat_sim(cfg):
    try:
        import habitat  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "habitat-sim is not installed; pass sim= explicitly (any "
            "HabitatSimLike object) or install habitat for VLN-CE evaluation"
        ) from e
    from internnav_tpu_torch.habitat.sim_adapter import HabitatSimAdapter

    return HabitatSimAdapter(cfg)


@Evaluator.register("habitat_default")
class HabitatDefaultEvaluator(HabitatVLNEvaluator):
    """Agent-server-based habitat eval (reference
    habitat_default_evaluator.py:30-153): any registry agent (or an
    AgentClient to a remote server when cfg.use_agent_server) drives
    discrete actions; no dual-system logic."""

    def _run_episode_dual(self, ep: Episode) -> Dict[str, Any]:
        obs = self.sim.reset(ep)
        self.agent.reset()
        trajectory = [np.asarray(self.sim.position)]
        steps = 0
        while steps < self.cfg.task.max_step and not self.sim.episode_over:
            o = dict(obs)
            o["instruction_text"] = ep.instruction_text
            o["instruction"] = (ep.instruction_tokens
                                if ep.instruction_tokens is not None
                                else np.zeros(8, np.int32))
            out = self.agent.step([o])[0]
            a = int(out["action"][0])
            obs = self.sim.step(a)
            trajectory.append(np.asarray(self.sim.position))
            steps += 1
            if a == 0:
                break
        return compute_all(np.asarray(trajectory), ep.reference_path,
                           ep.geodesic_distance,
                           self.cfg.task.metric_config.success_distance)

    _run_episode_system2 = _run_episode_dual
