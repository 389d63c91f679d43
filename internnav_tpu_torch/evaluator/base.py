"""Evaluator base + registry, and the distributed gather template.

Port of internnav_tpu/evaluator/base.py (the reference's
internnav/evaluator/base.py:6-39 registry, and distributed_base.py:70-149:
per-rank eval_action → gather → calc_metrics → rank-0 result.json append).

Distribution goes through `torch.distributed`: episodes are sharded per
process (rank::world_size) and the per-episode metrics are gathered as
JSON with `all_gather_object` when the process group has more than one
rank. Without an initialised process group the evaluator is one process:
rank 0 of 1, and the gather returns the local list. With
`use_agent_server` the agent is an `AgentClient` of the agent server at
cfg.agent's host and port (`comm/`, `scripts/torch/start_server.py`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

from internnav_tpu_torch.agent.base import Agent
from internnav_tpu_torch.configs.evaluator import EvalCfg
from internnav_tpu_torch.env.base import Env
from internnav_tpu_torch.parallel.collectives import get_rank, get_world_size
from internnav_tpu_torch.utils.logging import get_logger
from internnav_tpu_torch.utils.registry import Registry

evaluator_registry: Registry = Registry("evaluator")


def get_rank_world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) when no
    process group is initialised."""
    return get_rank(), get_world_size()


class Evaluator:
    def __init__(self, cfg: EvalCfg, env: Optional[Env] = None, agent: Optional[Agent] = None):
        self.cfg = cfg
        self.rank, self.world_size = get_rank_world()
        self.logger = get_logger("evaluator", cfg.output_dir)
        self.env = env
        self.agent = agent
        if self.env is None and cfg.env is not None:
            self.env = Env.init(cfg.env, cfg.task)
        if self.agent is None:
            if cfg.use_agent_server:
                from internnav_tpu_torch.comm.client import AgentClient

                self.agent = AgentClient(cfg.agent)
            else:
                self.agent = Agent.init(cfg.agent)

    register = staticmethod(evaluator_registry.register)

    #: modules whose import registers more evaluators ("habitat_vln",
    #: "habitat_default", "habitat_dialog"): `init` imports them when
    #: cfg.eval_type is not registered (they import this module)
    _LAZY_EVALUATOR_MODULES = (
        "internnav_tpu_torch.habitat.evaluator",
        "internnav_tpu_torch.dialog.evaluator",
    )

    @classmethod
    def init(cls, cfg: EvalCfg, **kwargs) -> "Evaluator":
        if cfg.eval_type not in evaluator_registry:
            import importlib

            for mod in cls._LAZY_EVALUATOR_MODULES:
                importlib.import_module(mod)
        return evaluator_registry.build(cfg.eval_type, cfg, **kwargs)

    # ------------------------------------------------------------- template
    def eval_action(self) -> List[Dict[str, Any]]:
        """Per-rank evaluation: returns this rank's per-episode metric dicts."""
        raise NotImplementedError

    def calc_metrics(self, per_episode: List[Dict[str, Any]]) -> Dict[str, float]:
        from internnav_tpu_torch.env.metrics import aggregate_metrics

        return aggregate_metrics(per_episode)

    def gather_results(self, local: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Every rank's per-episode dicts in rank order, each passed through
        JSON (non-JSON values as their str) as the JAX package's gather
        does; the local list itself when there is one rank."""
        if self.world_size == 1:
            return local
        payloads: List[Optional[str]] = [None] * self.world_size
        dist.all_gather_object(payloads, json.dumps(local, default=str))
        return [rec for p in payloads for rec in json.loads(p)]

    def eval(self) -> Dict[str, float]:
        t0 = time.time()
        local = self.eval_action()
        merged = self.gather_results(local)
        metrics = self.calc_metrics(merged)
        metrics["wall_clock_s"] = time.time() - t0
        if self.rank == 0:
            os.makedirs(self.cfg.output_dir, exist_ok=True)
            with open(os.path.join(self.cfg.output_dir, "result.json"), "a") as f:
                f.write(json.dumps(metrics, default=str) + "\n")
            self.logger.info("eval metrics: %s", metrics)
        return metrics
