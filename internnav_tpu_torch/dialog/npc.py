"""NPC for interactive dialog navigation (VL-LN / IIGN).

Reference parity: internnav/habitat_extensions/vlln/simple_npc/
simple_npc.py + prompt.py — an oracle NPC that answers the agent's
natural-language questions about the goal from scene annotations. Three
knowledge sources, all reproduced here:

1. goal information assembled from the scene's object_dict entry for the
   goal instance (room, color/texture/material/shape/placement adjectives,
   nearby objects, caption — simple_npc.py:62-78),
2. the path description synthesized by the oracle
   (internnav_tpu_torch.dialog.oracle.get_description; the reference's
   get_description.py), and
3. disambiguation yes/no confirmations (prompt.py DISAMBIGUATION_PROMPT).

The reference phrases answers with an OpenAI call
(habitat_dialog_evaluator.py:37-120); this environment has zero egress,
so an optional `llm_fn(prompt) -> str` hook takes that role and a
deterministic keyword classifier + template answers are the fallback.
`answer_question` mirrors the reference's one_turn/two_turn modes.

Copy of internnav_tpu/dialog/npc.py, kept in the port so that it imports
nothing of the JAX package (held equal to it by tests/test_torch_dialog.py).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional

import numpy as np

# Prompt templates (prompt.py:1-47). Shared strings by necessity: they are
# the NPC's LLM interface contract.
TEMPLATE = {
    "one_turn_prompt": """
You are a helpful assistant in helping agent to finish its navigation task.

## Here is the ground truth information you know more than the agent
'TASK DONE' shows if the agent has finished the task, if it is false, you need to know that the agent hasn't found the goal object.
'GOAL INFORMATION' shows the goal object's information.
'CORRECT PATH' shows the correct path description to the goal object.

TASK DONE:
{task_done}

GOAL INFORMATION:
{goal_information}

CORRECT PATH:
{path_description}

## Some constraints you MUST follow:
1. Only output the answer to the question.
2. Don't be verbose.

## Here is the question you need to answer
QUESTION: {question}
""",
    "two_turn_prompt_0": """
You are a helpful assistant in helping agent to finish its navigation task. You will be given a question among the following three types:
1. Disambiguation: This question is asked to check whether the agent has found the goal object. Like "Is it the object you are looking for?"
2. Path: This question is asked to get the path to the goal object. Like "Where should I go now?"
3. Information: This question is asked to get more information about the goal object. Like "Where is the goal object?", "What is the color of the goal object?"

You need to classify the question into one of the three types. Only output the name of the type(disambiguation, path, information). Don't be verbose.

## Here is the question you need to answer
QUESTION: {question}
""",
}

# prompt.py:49-87
DISAMBIGUATION_PROMPT = {
    "yes": [
        "Yes, you are in the correct position.",
        "That's right, you are at the intended location.",
        "Yes, you have reached the right spot.",
        "Correct, you are in the proper place.",
        "Yes, you are exactly where you need to be.",
        "Yes, you are aligned correctly.",
        "Yes, you are positioned accurately.",
        "Everything looks good, you are at the correct location.",
        "You are in the right area.",
        "Yes, you are currently at the correct position.",
        "That's perfect, you are in the right spot.",
        "Yes, your position is accurate.",
        "You have reached the proper location.",
        "Yes, you are at the specified position.",
        "Everything is aligned properly, you're in the correct spot.",
        "Yes, you are where you should be.",
        "Yes, this is the right place.",
    ],
    "no": [
        "This is not the intended location.",
        "You are not in the proper place.",
        "No, you are not where you need to be.",
        "No, you are not aligned correctly.",
        "No, you are positioned incorrectly.",
        "You are not at the correct location.",
        "No, you are situated incorrectly.",
        "You are in the wrong area.",
        "No, you are not currently at the correct position.",
        "That's not the right spot.",
        "No, you are not at the intended destination.",
        "Your position is inaccurate.",
        "You haven't reached the proper location.",
        "No, you are not at the specified position.",
        "The alignment is off, you are in the wrong spot.",
        "This is not the right place.",
    ],
}

# single source of truth for the MP3D region-label table (oracle.py);
# a copy here would drift
from internnav_tpu_torch.dialog.oracle import ROOM_NAMES  # noqa: E402


def goal_information(instance_id: str, object_dict: Dict[str, Any]) -> str:
    """Assemble the NPC's ground-truth goal description from scene
    annotations (simple_npc.py:62-78): room name, descriptive adjectives,
    nearby objects' fine-grained categories, and the caption."""
    info = object_dict[instance_id]
    out = "room: " + ROOM_NAMES[info["room"]] + "\n"
    desc = info.get("unique_description") or {}
    out += "\n".join(
        f"{k.lower()}: {v.lower()}" for k, v in desc.items()
        if k in ("color", "texture", "material", "shape", "placement") and len(v) > 0
    )
    nearby = [
        object_dict[obj]["unique_description"]["fine grained category"].lower()
        for obj in info.get("nearby_objects", {})
        if obj in object_dict
        and isinstance(object_dict[obj]["unique_description"], dict)
    ]
    if nearby:
        out += "\nnearby objects: " + ",".join(nearby)
    # no separator before "whole description:" — byte-parity with the
    # reference's concatenation (simple_npc.py:78)
    out += "whole description: " + info.get("caption", "")
    return out


def classify_question(question: str) -> str:
    """Deterministic stand-in for the reference's two_turn_prompt_0 LLM
    classification: disambiguation / path / information."""
    q = question.lower()
    if re.search(r"\bis (it|this|that)\b|am i (at|in|there)|have i (found|reached)"
                 r"|looking for\?|right (object|place|spot)|correct\b", q):
        return "disambiguation"
    if re.search(r"where should i go|which way|how (do|can) i (get|go|reach)"
                 r"|\bpath\b|\broute\b|\bdirections?\b|what('s| is) the way"
                 r"|where.*\bnow\b|next step", q):
        return "path"
    return "information"


class SimpleNPC:
    """Oracle NPC. Two operating levels:

    - `answer_question(...)` — the reference surface (simple_npc.py:58-127):
      requires scene annotations (object_dict + instance_id) and a
      path_description from the oracle; one_turn or two_turn modes.
    - `answer(...)` — convenience surface over a pre-digested `goal_info`
      dict for fixtures without full scene annotations.

    `llm_fn(prompt) -> str` replaces the reference's OpenAI call; without
    it, classification and phrasing are deterministic templates.
    """

    def __init__(self, goal_info: Optional[Dict[str, Any]] = None,
                 llm_fn: Optional[Callable[[str], str]] = None,
                 max_questions: int = 3,
                 rng: Optional[np.random.Generator] = None):
        self.goal = goal_info or {}
        self.llm_fn = llm_fn
        self.max_questions = max_questions
        self.questions_asked = 0
        self.history: List[Dict[str, str]] = []
        self.rng = rng or np.random.default_rng(0)

    def reset(self, goal_info: Optional[Dict[str, Any]] = None) -> None:
        if goal_info is not None:
            self.goal = goal_info
        self.questions_asked = 0
        self.history = []

    # ------------------------------------------------- reference surface
    def answer_question(self, question: str, instance_id: str,
                        object_dict: Dict[str, Any], task_done: bool,
                        path_description: Optional[str],
                        mode: str = "two_turn") -> Optional[str]:
        """simple_npc.py:58-127. `path_description` comes from
        oracle.get_description; None means no navigable path was found."""
        path_description = path_description or ""
        if mode == "one_turn":
            reply = self._ask(TEMPLATE["one_turn_prompt"].format(
                question=question,
                goal_information=goal_information(instance_id, object_dict),
                path_description=path_description, task_done=task_done))
        elif mode == "two_turn":
            kind = self._classify(question)
            if kind == "path":
                reply = path_description
            elif kind == "disambiguation":
                reply = str(self.rng.choice(
                    DISAMBIGUATION_PROMPT["yes" if task_done else "no"]))
            else:
                reply = self._ask(TEMPLATE["one_turn_prompt"].format(
                    question=question,
                    goal_information=goal_information(instance_id, object_dict),
                    path_description=path_description, task_done=task_done))
        else:
            raise ValueError(f"Invalid mode: {mode}")
        self.history.append({"question": question, "answer": reply or ""})
        return reply

    def _classify(self, question: str) -> str:
        if self.llm_fn is not None:
            verdict = (self.llm_fn(
                TEMPLATE["two_turn_prompt_0"].format(question=question)) or "").lower()
            for kind in ("path", "disambiguation", "information"):
                if kind in verdict:
                    return kind
        return classify_question(question)

    def _ask(self, prompt: str) -> str:
        if self.llm_fn is not None:
            try:
                reply = self.llm_fn(prompt)
                if reply:
                    return reply
            except Exception:
                pass
        return self._answer_from_prompt(prompt)

    def _answer_from_prompt(self, prompt: str) -> str:
        """Template fallback for information questions: surface the goal
        information block (the ground truth the LLM would paraphrase)."""
        m = re.search(r"GOAL INFORMATION:\n(.*?)\n\nCORRECT PATH:", prompt, re.S)
        if m:
            facts = m.group(1).strip()
            q = re.search(r"QUESTION: (.*)", prompt)
            ql = q.group(1).lower() if q else ""
            for key in ("color", "texture", "material", "shape", "placement",
                        "room"):
                if key in ql:
                    line = re.search(rf"^{key}: (.+)$", facts, re.M)
                    if line:
                        return f"The {key} is {line.group(1)}." if key != "room" \
                            else f"It is in the {line.group(1)}."
            if "near" in ql or "next to" in ql:
                line = re.search(r"^nearby objects: (.+)$", facts, re.M)
                if line:
                    return "It is near: " + line.group(1) + "."
            return facts
        return "I cannot answer that."

    # ------------------------------------------------ goal_info surface
    def answer(self, question: str, agent_position=None) -> str:
        self.questions_asked += 1
        if self.questions_asked > self.max_questions:
            reply = "I cannot answer any more questions."
        elif self.llm_fn is not None:
            reply = self.llm_fn(self._build_prompt(question))
        else:
            reply = self._template_answer(question, agent_position)
        self.history.append({"question": question, "answer": reply})
        return reply

    def _template_answer(self, question: str, agent_position=None) -> str:
        q = question.lower()
        obj = self.goal.get("object", "the target")
        room = self.goal.get("room")
        floor = self.goal.get("floor")
        nearby = self.goal.get("nearby") or []
        pos = self.goal.get("position")
        if re.search(r"which (room|area)|where.*(room|area)", q) and room:
            return f"It is in the {room}."
        if re.search(r"which floor|what floor|upstairs|downstairs", q) and floor is not None:
            return f"It is on floor {floor}."
        if re.search(r"near|next to|close to|around", q) and nearby:
            return f"It is near the {', '.join(map(str, nearby[:2]))}."
        if re.search(r"(what|which).*(look|color|kind)", q):
            return f"It is {obj}."
        if re.search(r"how far|distance", q) and pos is not None and agent_position is not None:
            d = float(np.linalg.norm(
                np.asarray(pos)[:2] - np.asarray(agent_position)[:2]))
            return f"It is about {d:.0f} meters away."
        if re.search(r"left|right|direction|which way", q) and pos is not None \
                and agent_position is not None and len(agent_position) >= 3:
            dx = np.asarray(pos)[:2] - np.asarray(agent_position)[:2]
            heading = np.arctan2(dx[1], dx[0]) - float(agent_position[2])
            heading = (heading + np.pi) % (2 * np.pi) - np.pi
            side = "ahead" if abs(heading) < 0.5 else ("to your left" if heading > 0 else "to your right")
            return f"It is {side}."
        parts = [f"The goal is {obj}"]
        if room:
            parts.append(f"in the {room}")
        if nearby:
            parts.append(f"near the {nearby[0]}")
        return " ".join(parts) + "."

    def _build_prompt(self, question: str) -> str:
        return (
            "You are a helpful resident. The navigation goal is "
            f"{self.goal}. Answer the agent's question concisely.\n"
            f"Question: {question}\nAnswer:"
        )
