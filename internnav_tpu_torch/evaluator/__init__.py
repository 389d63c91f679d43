"""Evaluators of the port: the registry and the distributed template
(`base.py`), the batched VLN evaluator and the pipelined multi-cohort one,
the VLN-PE evaluator ("vln_pe", the InternUtopia physics protocol), the
VN pointgoal evaluator ("vn_pointgoal"), and the Habitat evaluators
("habitat_vln", "habitat_default" in `habitat/evaluator.py`;
"habitat_dialog" in `dialog/evaluator.py`), which
register themselves on import: `Evaluator.init` imports their modules when
it is asked for an eval_type it does not know, and this package exposes
their classes lazily (importing them here would be circular: they import
`evaluator.base`)."""

from internnav_tpu_torch.evaluator.base import Evaluator, evaluator_registry, get_rank_world
from internnav_tpu_torch.evaluator.vln_evaluator import VLNBatchedEvaluator
from internnav_tpu_torch.evaluator.vln_pe_evaluator import VLNPEEvaluator
from internnav_tpu_torch.evaluator.vln_pipelined_evaluator import VLNPipelinedEvaluator
from internnav_tpu_torch.evaluator.vn_evaluator import VNPointGoalEvaluator

__all__ = ["Evaluator", "evaluator_registry", "get_rank_world", "VLNBatchedEvaluator",
           "VLNPEEvaluator", "VLNPipelinedEvaluator", "VNPointGoalEvaluator"]
_LAZY = {
    "HabitatVLNEvaluator": "internnav_tpu_torch.habitat.evaluator",
    "HabitatDefaultEvaluator": "internnav_tpu_torch.habitat.evaluator",
    "HabitatDialogEvaluator": "internnav_tpu_torch.dialog.evaluator",
}
__all__ += sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
