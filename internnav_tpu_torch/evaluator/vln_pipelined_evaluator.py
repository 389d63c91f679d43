"""Dual-cohort pipelined VLN evaluator.

Port of internnav_tpu/evaluator/vln_pipelined_evaluator.py, copied
unchanged but for the calls that take the port's signatures: a cohort's
`BatchedN1Policy(inner, batch_size, seed)`, `SharedDecodePool(inner)` and
`SharedS1Pool()`. Here a requested shared pool that the agents cannot take
raises instead of being skipped, and a cohort agent is only ever built
over cohort 0's shared policy (never a model of its own; an agent without
a policy, as the "simple" one, is built anew). The cohorts run
FakeEnv (env_type "fake"), the envs handed in (`envs=`), those an
`env_factory` builds, or for env_type "internutopia" one
`InternutopiaEnv` each behind `VLNPEBatchAdapter` (VLN-PE: FakePhysicsVecEnv
or Isaac); any other env_type raises.

`VLNBatchedEvaluator` leaves the accelerator idle whenever the host is
busy (simulator stepping, observation batching, result bookkeeping) and
vice versa. This evaluator splits the episode shard across N cohorts,
each with its own vectorized env and its own batched dual-system agent
slot state, ALL sharing one model (weights, decode caches and graphs). Cohorts
advance through `BatchedInternVLAN1Agent.step_coroutine`, which yields
at each async device submit — so while cohort A's fused S2/S1 program
runs on the accelerator, cohort B steps its simulators and builds its
next batch on the host. Device work is queued asynchronously (the CUDA
stream); everything runs on ONE host thread (see
serving.PipelinedN1Server).

The reference has no counterpart: its evaluator binds one episode to
one GPU rank and blocks on every device call
(reference internnav/evaluator/vln_distributed_evaluator.py:268-317).

Config: ``eval_type: "vln_pipelined"`` with ``env_settings["cohorts"]``
(default 2); each cohort runs ``env_num`` parallel episodes, so the GPU
serves ``cohorts * env_num`` streams.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from internnav_tpu_torch.configs.evaluator import EvalCfg
from internnav_tpu_torch.env.episodes import Episode
from internnav_tpu_torch.env.fake_env import FakeEnv
from internnav_tpu_torch.evaluator.base import Evaluator, get_rank_world
from internnav_tpu_torch.evaluator.utils.data_collector import EpisodeResultStore
from internnav_tpu_torch.evaluator.vln_evaluator import VLNBatchedEvaluator
from internnav_tpu_torch.utils.logging import ProgressLogger


def _step_coroutine(agent, batch):
    """agent.step as a scheduler coroutine. Agents exposing
    `step_coroutine` (the batched dual-system agent) yield at device-wait
    points for cross-cohort overlap; any other agent runs blocking inside
    a zero-yield generator — correct, just without the overlap."""
    if hasattr(agent, "step_coroutine"):
        return agent.step_coroutine(batch)

    def blocking():
        if False:  # pragma: no cover — makes this a generator
            yield
        return agent.step(batch)

    return blocking()


class _Cohort:
    """Per-cohort eval state: env + agent slots + FSM bookkeeping."""

    def __init__(self, idx: int, env, agent, progress: ProgressLogger,
                 store: EpisodeResultStore, latency=None) -> None:
        self.idx = idx
        self.env = env
        self.agent = agent
        self.progress = progress
        self.store = store
        self.latency = latency
        self.obs_list: List[Optional[Dict[str, Any]]] = []
        self.results: List[Dict[str, Any]] = []
        self._prev_count = 0

    def start(self) -> None:
        self.obs_list = self.env.reset()
        if self.latency is not None:
            self.latency.start(self.idx)
        for o in self.obs_list:
            if o is not None:
                self.progress.start(o["path_key"])

    def build_batch(self, fake_obs) -> Optional[List[Dict[str, Any]]]:
        """None when this cohort has no live episodes left."""
        if not self.env.is_running:
            return None
        batch, live = [], []
        for i, o in enumerate(self.obs_list):
            if o is None or o.get("done", False) or o.get("warming_up", False):
                # warm-up slots get fake obs exactly like the reference
                # (vln_distributed_evaluator.py:130-137): the env adapter
                # discards their action (forced stand_still) and the agent
                # slot is reset once warm-up completes (see apply()).
                batch.append(fake_obs())
            else:
                batch.append(o)
                live.append(i)
        if live or any(o is not None and o.get("warming_up", False)
                       for o in self.obs_list):
            return batch
        return None

    def apply(self, agent_out: List[Dict[str, Any]]) -> None:
        """env.step + terminate_ops for one macro-step."""
        live = sum(1 for o in self.obs_list
                   if o is not None and not o.get("done", False))
        was_warming = {i for i, o in enumerate(self.obs_list)
                       if o is not None and o.get("warming_up", False)}
        actions = [int(a["action"][0]) for a in agent_out]
        self.obs_list = self.env.step(actions)
        if self.latency is not None:
            self.latency.mark(self.idx, live)
        # slots whose warm-up just completed: reset the agent slot state
        # (polluted by fake obs during warm-up) before its first real step
        # — reference terminate_ops :194-197
        warmed = [i for i in was_warming
                  if self.obs_list[i] is not None
                  and not self.obs_list[i].get("warming_up", False)
                  and not self.obs_list[i].get("done", False)]
        if warmed:
            self.agent.reset(warmed)
        for o in self.obs_list:
            if o is not None and not o.get("done", False) \
                    and not o.get("warming_up", False):
                self.progress.step(o["path_key"])
        new = self.env.episode_results[self._prev_count:]
        if new:
            done_ids = [i for i, o in enumerate(self.obs_list)
                        if o is not None and o.get("done", False)]
            for rec in new:
                key = str(rec.get("path_key") or rec.get("episode_id", ""))
                self.store.save_eval_result(
                    key=key, fail_reason=rec.get("fail_reason", ""), info=rec)
                self.progress.end(key, "success" if rec.get("success") else
                                  (rec.get("fail_reason") or "fail"))
            self.results.extend(new)
            self._prev_count += len(new)
            if done_ids:
                self.agent.reset(done_ids)
                self.obs_list = self.env.reset(done_ids)
                for i in done_ids:
                    o = self.obs_list[i]
                    if o is not None:
                        self.progress.start(o["path_key"])


@Evaluator.register("vln_pipelined")
class VLNPipelinedEvaluator(VLNBatchedEvaluator):
    """See module docstring. Subclasses VLNBatchedEvaluator for episode
    loading / metrics / resume; replaces the step loop with the
    round-robin coroutine scheduler over N cohorts."""

    def __init__(self, cfg: EvalCfg, episodes: Optional[List[Episode]] = None,
                 envs: Optional[List[Any]] = None, env_factory=None, **kwargs):
        """``envs``: pre-built cohort envs speaking the batched obs-list
        protocol (one per cohort; sets the cohort count). ``env_factory``:
        callable ``(cohort_idx, env_cfg, task_cfg, episodes) -> env`` used
        to build each cohort's env — also readable from
        env_settings["env_factory"]. With neither, fake envs are built
        in-process and any other env_type goes through `_make_cohort_env`
        (for "internutopia", ``VLNPEBatchAdapter`` over one
        InternutopiaEnv per cohort)."""
        settings = cfg.env.env_settings or {}
        self._env_factory = env_factory or settings.get("env_factory")
        self._prebuilt_envs = list(envs) if envs is not None else None
        if self._prebuilt_envs is not None:
            self.cohort_count = len(self._prebuilt_envs)
            kwargs.setdefault("env", self._prebuilt_envs[0])
        else:
            self.cohort_count = int(settings.get("cohorts", 2))
        # env_settings["overlap_apply"]=False restores the pre-overlap
        # barrier form (all cohorts' env stepping as a serial host phase
        # after the macro-step barrier) — kept as an A-B measurement lever.
        self._overlap_apply = bool(settings.get("overlap_apply", True))
        if self._prebuilt_envs is None and cfg.env.env_type != "fake":
            # any real env_type builds its cohorts here, cohorts=1 too: the
            # base class would otherwise refuse it
            episodes, self._prebuilt_envs = self._build_real_envs(cfg, episodes)
            kwargs.setdefault("env", self._prebuilt_envs[0])
        super().__init__(cfg, episodes=episodes, **kwargs)

    def _build_real_envs(self, cfg: EvalCfg, episodes):
        """Pre-split the (resume-filtered) episode shard across cohorts and
        build one real env per cohort — real sims bind episodes at
        construction, so the post-hoc re-scope used for fake envs can't
        apply. The base __init__ repeats the load/shard/pending bookkeeping
        idempotently against the same resume store."""
        from internnav_tpu_torch.env.episodes import (
            ResumableEpisodeLoader,
            group_by_scene,
            shard_episodes,
        )

        rank, world = get_rank_world()
        store = EpisodeResultStore(root=f"{cfg.output_dir}/resume", rank=rank)
        if episodes is None:
            episodes = self._load_episodes(cfg)
        sharded = shard_episodes(group_by_scene(episodes), rank, world)
        pending = ResumableEpisodeLoader(
            sharded, store=store, retry_list=cfg.dataset.retry_list).pending()
        n = self.cohort_count
        shares = [pending[c::n] for c in range(n)]
        envs = [self._make_cohort_env(cfg, c, share) for c, share in enumerate(shares)]
        return episodes, envs

    def _make_cohort_env(self, cfg: EvalCfg, idx: int, episodes: List[Episode]):
        """One cohort env for a real sim backend. ``env_factory`` wins;
        otherwise env_type "internutopia" gets an InternutopiaEnv wrapped
        in the batched-protocol adapter. Other backends must provide a
        factory (the habitat stack has its own evaluator protocol)."""
        if self._env_factory is not None:
            return self._env_factory(idx, cfg.env, cfg.task, episodes)
        if cfg.env.env_type == "internutopia":
            from internnav_tpu_torch.env.internutopia.batch_adapter import VLNPEBatchAdapter
            from internnav_tpu_torch.env.internutopia.env import InternutopiaEnv

            env = InternutopiaEnv(cfg.env, cfg.task, episodes=episodes)
            return VLNPEBatchAdapter(
                env, robot_name=cfg.task.robot_name,
                robot_flash=cfg.task.robot_flash, episodes=episodes,
                rgb_hw=tuple(cfg.task.camera_resolution or (256, 256)))
        raise NotImplementedError(
            f"vln_pipelined has no default cohort env for "
            f"env_type={cfg.env.env_type!r}; pass envs= or env_factory=")

    # the base class builds env + agent for cohort 0; add the rest lazily
    def _build_cohorts(self) -> List[_Cohort]:
        from internnav_tpu_torch.evaluator.utils.latency import CohortLatencyTracker

        cfg = self.cfg
        n = self.cohort_count
        self._latency = CohortLatencyTracker(n)
        settings = cfg.env.env_settings or {}
        for pool, setting in (("decode_pool", "shared_decode"), ("s1_pool", "shared_s1")):
            if settings.get(setting):  # before any cohort agent is made
                _require_dual_system([self.agent], pool, setting)
        cohorts: List[_Cohort] = [_Cohort(0, self.env, self.agent, self.progress, self.store,
                                          latency=self._latency)]
        if self._prebuilt_envs is not None:
            # each env owns its episode share already (pre-built or
            # pre-split at construction): no post-hoc re-scope
            envs = self._prebuilt_envs[1:]
        else:
            pending = list(getattr(self.env, "episodes", []))
            shares = [pending[c::n] for c in range(n)]
            # cohort 0 reuses the already-built env/agent; re-scope episodes
            self.env.episodes = shares[0]
            envs = [FakeEnv(cfg.env, cfg.task, episodes=shares[c]) for c in range(1, n)]
        for c, env in enumerate(envs, start=1):
            cohorts.append(_Cohort(c, env, self._make_cohort_agent(c), self.progress,
                                   self.store, latency=self._latency))
        self._attach_decode_pool(cohorts)
        self._attach_s1_pool(cohorts)
        return cohorts

    def _attach_decode_pool(self, cohorts: List["_Cohort"]) -> None:
        """env_settings["shared_decode"]: batch every cohort's greedy S2
        decode into one grouped device program (one decoder weight stream
        per token serves all cohorts). Requires dual-system agents sharing
        one BatchedN1Policy inner; raises ValueError otherwise, so that a
        shared decode that was asked for is never quietly left off."""
        settings = getattr(self.cfg.env, "env_settings", None) or {}
        if not settings.get("shared_decode"):
            return
        agents = [c.agent for c in cohorts]
        _require_dual_system(agents, "decode_pool", "shared_decode")
        from internnav_tpu_torch.model.basemodel.internvla_n1.serving import (
            SharedDecodePool,
        )

        inner = agents[0].policy.inner
        pool = SharedDecodePool(inner)
        for a in agents:
            a.decode_pool = pool

    def _attach_s1_pool(self, cohorts: List["_Cohort"]) -> None:
        """env_settings["shared_s1"]: batch every cohort's System-1 denoise
        into one grouped DiT program per scheduler pass
        (serving.s1_grouped_dispatch — row-identical up to float epsilon).
        Requires dual-system agents sharing one BatchedN1Policy inner;
        raises ValueError otherwise."""
        settings = getattr(self.cfg.env, "env_settings", None) or {}
        if not settings.get("shared_s1"):
            return
        agents = [c.agent for c in cohorts]
        _require_dual_system(agents, "s1_pool", "shared_s1")
        from internnav_tpu_torch.model.basemodel.internvla_n1.serving import (
            SharedS1Pool,
        )

        pool = SharedS1Pool()
        for a in agents:
            a.s1_pool = pool

    def _make_cohort_agent(self, idx: int):
        """A new agent of cohort 0's type with its own slot state, over a
        BatchedN1Policy that shares cohort 0's inner policy (weights,
        decode caches and graphs); cohort idx draws its System-1 noise
        from seed idx, as PipelinedN1Server's cohorts do. A recurrent agent
        (CMA, Seq2Seq) shares cohort 0's policy object itself, with its own
        recurrent states, as the JAX evaluator's cohorts do. An agent that
        holds no policy at all (the "simple" agent) gets a new one of its
        own from the registry, as the JAX evaluator's fallback builds it.
        Raises ValueError when cohort 0's agent has a policy but none of
        these to share: a cohort never builds a model of its own."""
        from internnav_tpu_torch.agent.recurrent_agent import _RecurrentAgentBase

        base = self.agent
        if not hasattr(base, "policy"):
            from internnav_tpu_torch.agent.base import Agent

            return Agent.init(self.cfg.agent)
        if isinstance(base, _RecurrentAgentBase):
            return type(base)(base.cfg, policy=base.policy)
        inner = getattr(getattr(base, "policy", None), "inner", None)
        if inner is None:
            raise ValueError(f"vln_pipelined cohorts share cohort 0's policy, and "
                             f"{type(base).__name__} has none to share (a BatchedN1Policy "
                             f"with an inner policy, or a recurrent agent's policy)")
        from internnav_tpu_torch.model.basemodel.internvla_n1.serving import BatchedN1Policy

        return type(base)(base.cfg, policy=BatchedN1Policy(inner, base.policy.batch_size,
                                                           seed=idx))

    def eval_action(self) -> List[Dict[str, Any]]:
        cohorts = self._build_cohorts()
        by_idx = {c.idx: c for c in cohorts}
        for c in cohorts:
            c.start()
        gens: Dict[int, Any] = {}
        while True:
            # phase 0: spawn a coroutine per live cohort (submits its first
            # device program, then yields). Cohorts stay in macro-step
            # lockstep so the shared decode/S1 pools group every cohort's
            # work into one device program.
            gens.clear()
            for c in cohorts:
                batch = c.build_batch(self._fake_obs)
                if batch is not None:
                    gens[c.idx] = _step_coroutine(c.agent, batch)
            if not gens:
                break
            # round-robin: advance each coroutine one hop per pass, so one
            # cohort's host work runs while the others' programs execute.
            # A cohort's env stepping + bookkeeping (apply) runs the moment
            # ITS coroutine completes — overlapping the peers' still
            # in-flight device programs and fetches, instead of a serial
            # all-cohorts host phase after the barrier (measured: the
            # barrier form left the chip idle for the entire sim-stepping
            # phase every macro-step; see docs/BENCH_METHOD.md).
            live = dict(gens)
            deferred: List[Any] = []
            while live:
                for ci in list(live):
                    try:
                        next(live[ci])
                    except StopIteration as stop:
                        del live[ci]
                        if self._overlap_apply:
                            by_idx[ci].apply(stop.value)
                        else:
                            deferred.append((ci, stop.value))
            for ci, value in deferred:  # barrier form (overlap_apply=False)
                by_idx[ci].apply(value)
        results: List[Dict[str, Any]] = []
        for c in cohorts:
            results.extend(c.results)
        for rec in self.store.records():
            info = rec.get("info") or {}
            if info and info.get("episode_id") not in {
                    r.get("episode_id") for r in results}:
                results.append(info)
        self.progress.report()
        self.latency_summary = self._latency.summary()
        return results


def _require_dual_system(agents: List[Any], pool: str, setting: str) -> None:
    """A shared pool needs batched dual-system agents (a `pool` attribute)
    over one BatchedN1Policy inner each."""
    bad = [type(a).__name__ for a in agents
           if not (hasattr(a, pool) and hasattr(getattr(a, "policy", None), "inner"))]
    if bad:
        raise ValueError(f"env_settings[{setting!r}] needs batched dual-system agents "
                         f"(BatchedInternVLAN1Agent over a BatchedN1Policy), got {bad}")
