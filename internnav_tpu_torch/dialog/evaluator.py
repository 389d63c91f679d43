"""Dialog (VL-LN / IIGN) evaluator — NPC-in-the-loop navigation.

Reference parity: internnav/habitat_extensions/vlln/
habitat_dialog_evaluator.py:130-210 — the agent may ask the NPC questions
mid-episode (an 'ask' action); the NPC answers from scene ground truth:
a path description synthesized by the oracle from the shortest navigable
path + MP3D region/object annotations (get_description), goal-instance
information, or a disambiguation yes/no. Metrics additionally track the
question count.

Scene annotations ride on the episode: `ep.extra['object_dict']`,
`ep.extra['region_dict']`, `ep.extra['instance_id']` (the reference loads
object_dict.json / region_dict.json per scene,
habitat_dialog_evaluator.py:144-147). Without them the agent's own
pre-digested goal_info NPC answers instead (fixture mode).

Copy of internnav_tpu/dialog/evaluator.py over the port's agent, NPC,
oracle and sims.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from internnav_tpu_torch.dialog.dialog_agent import DialogAgent
from internnav_tpu_torch.dialog.npc import SimpleNPC
from internnav_tpu_torch.dialog.oracle import get_description
from internnav_tpu_torch.env.episodes import Episode
from internnav_tpu_torch.evaluator.base import Evaluator
from internnav_tpu_torch.habitat.measures import compute_all

ASK_ACTION = 4


@Evaluator.register("habitat_dialog")
class HabitatDialogEvaluator(Evaluator):
    def __init__(self, cfg, sim=None, episodes: Optional[List[Episode]] = None,
                 agent: Optional[DialogAgent] = None,
                 npc: Optional[SimpleNPC] = None, **kwargs):
        from internnav_tpu_torch.habitat.sim_adapter import FakeSim

        self.sim = sim if sim is not None else FakeSim()
        self.episodes = list(episodes or [])
        self.npc = npc or SimpleNPC()
        kwargs.setdefault("env", _Null())
        super().__init__(cfg, agent=agent, **kwargs)

    def eval_action(self) -> List[Dict[str, Any]]:
        results = []
        for ep in self.episodes:
            results.append(self._run_episode(ep))
        return results

    def _npc_answer(self, ep: Episode, question: str) -> Optional[str]:
        """Oracle-backed NPC turn (habitat_dialog_evaluator.py:186-196):
        synthesize the path description from the sim's current state +
        scene annotations, judge task_done by remaining path length, and
        answer in two_turn mode."""
        object_dict = ep.extra.get("object_dict")
        region_dict = ep.extra.get("region_dict")
        instance_id = ep.extra.get("instance_id")
        if not (object_dict and region_dict and instance_id):
            return None
        path_description, pl = get_description(self.sim, ep, object_dict,
                                               region_dict)
        # path-search failure yields pl=inf (unknown is never arrival);
        # a degenerate at-goal path yields pl=0 with no description
        task_done = pl < 3  # reference also requires the goal in view
        answer = self.npc.answer_question(
            question=question, instance_id=instance_id,
            object_dict=object_dict, task_done=bool(task_done),
            path_description=path_description, mode="two_turn")
        return answer or "Sorry, I can not answer your question now."

    def _run_episode(self, ep: Episode) -> Dict[str, Any]:
        obs = self.sim.reset(ep)
        self.agent.reset()
        goal_info = ep.extra.get("goal_info")
        if goal_info and isinstance(self.agent, DialogAgent):
            self.agent.npc.reset(goal_info)
        trajectory = [np.asarray(self.sim.position)]
        questions = 0
        dialogs: List[Dict[str, str]] = []
        npc_answer: Optional[str] = None
        steps = 0
        while steps < self.cfg.task.max_step and not self.sim.episode_over:
            o = dict(obs)
            o["instruction_text"] = ep.instruction_text
            o["globalgps"] = np.asarray(self.sim.position)
            o["yaw"] = float(getattr(self.sim, "yaw", 0.0))
            if npc_answer is not None:
                o["npc_answer"] = npc_answer
                npc_answer = None
            out = self.agent.step([o])[0]
            a = int(out["action"][0])
            if a == ASK_ACTION:
                questions += 1
                steps += 1  # asking consumes a step but no motion
                question = out.get("question", "")
                if questions > self.npc.max_questions:
                    npc_answer = ("Sorry, you have reached the question "
                                  "limit. No further answers are available.")
                else:
                    npc_answer = self._npc_answer(ep, question)
                if npc_answer is not None:
                    dialogs.append({"question": question, "answer": npc_answer})
                continue
            obs = self.sim.step(a)
            trajectory.append(np.asarray(self.sim.position))
            steps += 1
            if a == 0:
                break
        rec = compute_all(np.asarray(trajectory), ep.reference_path,
                          ep.geodesic_distance,
                          self.cfg.task.metric_config.success_distance)
        rec["questions"] = float(questions)
        rec["episode_id"] = ep.episode_id
        rec["split"] = ep.split
        if dialogs:
            rec["dialogs"] = dialogs
        return rec


class _Null:
    is_running = True

    def close(self):
        pass
