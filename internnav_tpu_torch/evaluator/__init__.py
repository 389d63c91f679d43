"""Evaluators of the port: the registry and the distributed template
(`base.py`), the batched VLN evaluator and the pipelined multi-cohort one.
The other evaluators (VLN-PE, VN, habitat, dialog) are not ported yet
(ROADMAP §1 item 7)."""

from internnav_tpu_torch.evaluator.base import Evaluator, evaluator_registry, get_rank_world
from internnav_tpu_torch.evaluator.vln_evaluator import VLNBatchedEvaluator
from internnav_tpu_torch.evaluator.vln_pipelined_evaluator import VLNPipelinedEvaluator

__all__ = ["Evaluator", "evaluator_registry", "get_rank_world", "VLNBatchedEvaluator",
           "VLNPipelinedEvaluator"]
