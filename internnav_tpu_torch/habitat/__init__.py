"""Habitat VLN-CE evaluation of the port (copies of internnav_tpu/habitat/
over the port's classes): the "habitat_vln" and "habitat_default"
evaluators, the habitat measures, the kinematic sims and the registered
"habitat" env (`habitat.env`, imported on its own)."""

from internnav_tpu_torch.habitat.evaluator import (
    HabitatDefaultEvaluator,
    HabitatVLNEvaluator,
    preprocess_depth,
)
from internnav_tpu_torch.habitat.measures import compute_all
from internnav_tpu_torch.habitat.sim_adapter import FakeSim, NavmeshFakeSim

__all__ = ["HabitatVLNEvaluator", "HabitatDefaultEvaluator", "preprocess_depth",
           "compute_all", "FakeSim", "NavmeshFakeSim"]
