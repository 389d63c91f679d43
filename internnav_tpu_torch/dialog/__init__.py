"""VL-LN dialog evaluation of the port (copies of internnav_tpu/dialog/):
the "dialog" agent, the "habitat_dialog" evaluator, the NPC, the
path-description oracle and the MP3D ground-truth perception helpers."""

from internnav_tpu_torch.dialog.dialog_agent import DialogAgent, pixel_to_gps
from internnav_tpu_torch.dialog.evaluator import HabitatDialogEvaluator
from internnav_tpu_torch.dialog.mp3d import MP3DGTPerception, fill_small_holes
from internnav_tpu_torch.dialog.npc import SimpleNPC

__all__ = ["DialogAgent", "pixel_to_gps", "HabitatDialogEvaluator",
           "SimpleNPC", "MP3DGTPerception", "fill_small_holes"]
