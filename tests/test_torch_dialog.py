"""The port's VL-LN dialog evaluation against the JAX package's.

- The path-description oracle on seeded synthetic MP3D-style scenes (a
  grid of rooms with annotated objects, random walks through them): every
  function `tests/test_dialog_oracle.py` holds against the reference
  (`point_in_polygon`, `sample_points`, `find_sharp_turns`,
  `yaw_rotation_to`, rooms and nearest objects, fill and minimize,
  `describe_path`, `describe_path_plain`, `landmark_name`) and
  `get_description`, held here against internnav_tpu/dialog/oracle.py with
  the same seeded phrase picks on both sides: exactly equal.
- The NPC: question classification, goal information, the two-turn and
  one-turn answers and the goal_info template answers: equal strings.
- The MP3D perception helpers and `pixel_to_gps`: exactly equal.
- `DialogAgent` + `HabitatDialogEvaluator` on the tiny fp32 policies of
  tests/test_torch_slice.py with the scripted tokenizer of
  tests/test_torch_habitat.py: a question, its NPC answer (the agent's own
  goal_info NPC in one episode, the evaluator's oracle NPC in the other),
  a pixel goal with its goal_gps, actions and STOP; records, the agents'
  outputs and the sims' action logs equal to the JAX run's.
- The dialog agent builds its own policy on the GPU unless asked for the
  CPU; `Evaluator.init` and `Agent.init` find the dialog and habitat
  classes in a fresh interpreter.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from internnav_tpu import configs as jconfigs
from internnav_tpu.dialog import dialog_agent as jagent
from internnav_tpu.dialog import evaluator as jdeval
from internnav_tpu.dialog import mp3d as jmp3d
from internnav_tpu.dialog import npc as jnpc
from internnav_tpu.dialog import oracle as jor
from internnav_tpu.env import episodes as jepisodes
from internnav_tpu.habitat import sim_adapter as jsim
from internnav_tpu.utils import geometry as jgeo
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch.dialog import dialog_agent as tagent
from internnav_tpu_torch.dialog import evaluator as tdeval
from internnav_tpu_torch.dialog import mp3d as tmp3d
from internnav_tpu_torch.dialog import npc as tnpc
from internnav_tpu_torch.dialog import oracle as tor
from internnav_tpu_torch.env import episodes as tepisodes
from internnav_tpu_torch.habitat import sim_adapter as tsim
from internnav_tpu_torch.utils import geometry as tgeo
from test_torch_habitat import logged, scripted_pair
from test_torch_slice import policies  # noqa: F401

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SEEDS = range(6)
CATEGORIES = ("sofa", "table", "chair", "bed", "lamp", "cabinet", "wall", "floor", "column")
ROOMS = ("living region", "cooking region", "bathing region", "study region",
         "corridor region", "dinning region")
COLORS = ("Red", "Brown", "White", "", "Blue")


def picker(seed):
    """A seeded phrase pick: the same sequence for both packages."""
    rng = np.random.default_rng(seed)
    return lambda seq: seq[int(rng.integers(len(seq)))]


def scene(seed):
    """(region_dict, object_dict, path): a 2 x 2 grid of 5 m rooms in the
    ply ground plane (x, -z), 2-4 annotated objects a room (one of them
    not structural), and a 0.5 m-high walk through the rooms in habitat
    coordinates (x, up, z)."""
    r = np.random.default_rng(seed)
    regions, objects = [], {}
    for i in range(4):
        x0, y0 = -5 + 5 * (i % 2), 5 * (i // 2)
        label = ROOMS[int(r.integers(len(ROOMS)))]
        regions.append({"label": label, "id": i,
                        "poly": [[x0, y0], [x0 + 5, y0], [x0 + 5, y0 + 5], [x0, y0 + 5]],
                        "enlarge_poly": [[x0 - 1, y0 - 1], [x0 + 6, y0 - 1], [x0 + 6, y0 + 6],
                                         [x0 - 1, y0 + 6]]})
        for j in range(int(r.integers(2, 5))):
            cat = CATEGORIES[int(r.integers(6 if j == 0 else len(CATEGORIES)))]
            name = f"{cat}_{i}_{j}"
            desc = ("" if cat == "wall" else
                    {"color": COLORS[int(r.integers(len(COLORS)))],
                     "texture": ["", "Smooth"][int(r.integers(2))],
                     "material": ["Wood", "", "Metal"][int(r.integers(3))],
                     "fine grained category": f"fine {cat}"})
            objects[name] = {
                "scope": "level0", "room": label,
                "position": [float(x0 + r.uniform(0.3, 4.7)), float(r.uniform(0.2, 1.8)),
                             float(-(y0 + r.uniform(0.3, 4.7)))],
                "category": cat, "unique_description": desc,
                "nearby_objects": {}, "caption": f"a {cat} in room {i}"}
    names = list(objects)
    for n in names:
        objects[n]["nearby_objects"] = {m: 1.0 for m in r.choice(names, 2, replace=False)}
    steps = r.uniform(-0.6, 1.2, (int(r.integers(8, 16)), 2))
    xz = np.clip(np.asarray([-3.0, -1.0]) + np.cumsum(steps * [1.0, -1.0], axis=0),
                 [-4.7, -9.7], [4.7, -0.3])
    path = [np.asarray([x, 0.5, z]) for x, z in xz]
    return {"level0": regions}, objects, path


@pytest.mark.parametrize("seed", SEEDS)
def test_oracle_functions_match_jax(seed):
    region_dict, object_dict, path = scene(seed)
    r = np.random.default_rng(100 + seed)
    pts = np.cumsum(r.uniform(-0.5, 0.8, (30, 3)), axis=0)
    rooms = [f"r{int(i)}" for i in r.integers(0, 3, 30)]
    assert tor.sample_points(pts, rooms, 1.0) == jor.sample_points(pts, rooms, 1.0)
    for up in (1, 2):
        for a, b in zip(tor.find_sharp_turns(pts, 40.0, up), jor.find_sharp_turns(pts, 40.0, up)):
            np.testing.assert_array_equal(a, b)
    poly = r.uniform(-3, 3, (6, 2))
    np.testing.assert_array_equal(tor.point_in_polygon(pts[:, :2], poly),
                                  jor.point_in_polygon(pts[:, :2], poly))
    for rot in (float(r.uniform(-3, 3)), jor.quat_from_yaw(0.4), np.asarray([0.6, 0.0, -0.8])):
        tgt = r.uniform(-3, 3, 3)
        assert tor.yaw_rotation_to(rot, [0, 0, 0], tgt) == jor.yaw_rotation_to(rot, [0, 0, 0], tgt)
    np.testing.assert_array_equal(tor._rotation_matrix(tor.quat_from_yaw(1.1)),
                                  jor._rotation_matrix(jor.quat_from_yaw(1.1)))
    labels = [["", "a", "b"][int(i)] for i in r.integers(0, 3, 9)]
    assert tor._fill_empty_with_nearest(labels) == jor._fill_empty_with_nearest(labels)
    opts = [[["a", "b", "c"][int(i)] for i in r.integers(0, 3, int(k))]
            for k in r.integers(0, 4, 7)]
    assert tor._minimize_unique_strings(opts) == jor._minimize_unique_strings(opts)
    ts, js = tor.SceneOracle(object_dict, region_dict), jor.SceneOracle(object_dict, region_dict)
    assert ts.rooms_at(path) == js.rooms_at(path)
    assert ts.rooms_at(path, "enlarge_poly") == js.rooms_at(path, "enlarge_poly")
    assert ts.nearest_objects(path) == js.nearest_objects(path)
    for name in list(object_dict)[::2]:
        pos = np.asarray(object_dict[name]["position"]) + [0.3, 0.1, -0.2]
        assert ts.landmark_name(pos, name, picker(seed)) == js.landmark_name(pos, name,
                                                                            picker(seed))
    yaw = float(r.uniform(-3, 3))
    heights = [0.5] * len(path)
    for turn_sign in (1.0, -1.0):
        ours = tor.describe_path(yaw, path, object_dict, region_dict, heights, picker(seed),
                                 turn_sign)
        assert ours == jor.describe_path(yaw, path, object_dict, region_dict, heights,
                                         picker(seed), turn_sign)
        assert ours.startswith("1. ")
    stairs = [0.5 + 0.3 * (i > len(path) // 2) for i in range(len(path))]
    for heights in (None, stairs):
        assert tor.describe_path_plain(yaw, path, heights, picker(seed)) == \
            jor.describe_path_plain(yaw, path, heights, picker(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_get_description_matches_jax(seed):
    """On the planar FakeSim (no navmesh: the reference path from its
    nearest vertex), from the start and after a few steps."""
    region_dict, object_dict, path = scene(seed)
    planar = np.asarray([[p[0], p[2], p[1]] for p in path])
    out = []
    for sims, eps in ((jsim, jepisodes), (tsim, tepisodes)):
        ep = eps.Episode(episode_id="d", trajectory_id="t", scene_id="s", instruction_text="",
                         instruction_tokens=None, start_position=planar[0],
                         start_rotation=np.zeros(4), reference_path=planar,
                         geodesic_distance=1.0,
                         extra={"goal_position": planar[-1].tolist()})
        sim = sims.FakeSim(rgb_hw=(8, 8))
        sim.reset(ep)
        got = []
        for a in (None, 1, 2, 1, 1):
            if a is not None:
                sim.step(a)
            get = (tor if sims is tsim else jor).get_description
            got.append(get(sim, ep, object_dict, region_dict, picker(seed)))
        out.append(got)
    assert out[1] == out[0]
    assert out[1][0][0].startswith("1. ") and out[1][0][1] > 0


QUESTIONS = ("Where should I go now?", "Is it the object you are looking for?",
             "What is the color of the goal object?", "Which room is it in?",
             "What is it near?", "how far is it?", "is it to my left or right?",
             "what floor?", "What does it look like?", "random words", "am i there?",
             "Which way do I go next step?", "What material is it made of?")


def test_npc_matches_jax():
    _, object_dict, _ = scene(1)
    name = next(iter(object_dict))
    assert tnpc.goal_information(name, object_dict) == jnpc.goal_information(name, object_dict)
    assert tnpc.ROOM_NAMES == jnpc.ROOM_NAMES and tnpc.TEMPLATE == jnpc.TEMPLATE
    assert tnpc.DISAMBIGUATION_PROMPT == jnpc.DISAMBIGUATION_PROMPT
    goal = {"object": "the red sofa", "room": "living room", "floor": 1,
            "nearby": ["table", "lamp"], "position": [3.0, 4.0]}

    def llm(prompt):
        return "information" if "three types" in prompt else "an llm answer"

    answers = []
    for mod in (jnpc, tnpc):
        got = [mod.classify_question(q) for q in QUESTIONS]
        for llm_fn in (None, llm):
            npc = mod.SimpleNPC(goal, llm_fn=llm_fn, max_questions=len(QUESTIONS) - 2)
            for mode in ("two_turn", "one_turn"):
                for task_done in (False, True):
                    got += [npc.answer_question(q, name, object_dict, task_done, "THE PATH",
                                                mode) for q in QUESTIONS]
            got += [npc.answer(q, agent_position=[0.5, -1.0, 0.3]) for q in QUESTIONS]
            got.append(npc.history)
        with pytest.raises(ValueError, match="Invalid mode"):
            mod.SimpleNPC().answer_question("q", name, object_dict, False, "", "three_turn")
        answers.append(got)
    assert answers[1] == answers[0]
    assert set(answers[1][:len(QUESTIONS)]) == {"path", "disambiguation", "information"}


def test_mp3d_helpers_and_pixel_to_gps_match_jax():
    r = np.random.default_rng(3)
    depth = np.full((40, 48), 0.4, np.float32)
    depth[3:5, 3:5] = 0
    depth[10:30, 10:30] = 0
    for area in (10, 600):
        np.testing.assert_array_equal(tmp3d.fill_small_holes(depth, area),
                                      jmp3d.fill_small_holes(depth, area))
    d = r.uniform(0.1, 1.0, (40, 48)).astype(np.float32)
    mask = d > 0.4
    np.testing.assert_array_equal(tmp3d.get_point_cloud(d, mask, 30.0, 32.0),
                                  jmp3d.get_point_cloud(d, mask, 30.0, 32.0))
    tf = np.eye(4)
    tf[:2, :2] = tgeo.yaw_rotmat(0.3)
    tf[:3, 3] = [0.2, -0.1, 0.5]
    pts = r.uniform(-2, 2, (50, 3))
    for fn in ("transform_points", "inverse_transform_points"):
        np.testing.assert_array_equal(getattr(tmp3d, fn)(tf, pts), getattr(jmp3d, fn)(tf, pts))
    np.testing.assert_array_equal(tmp3d.project_points_to_image(pts, 30.0, 30.0, (40, 48)),
                                  jmp3d.project_points_to_image(pts, 30.0, 30.0, (40, 48)))
    targets = np.asarray([[-0.5, -10, 0.5, 1.0, 10, 6.0], [5, 5, 5, 6, 6, 6]])
    for mod in (tmp3d, jmp3d):
        mod.out = mod.MP3DGTPerception(5.0, 0.1, 30.0, 30.0).predict(d, targets, tf, 4)
    np.testing.assert_array_equal(tmp3d.out, jmp3d.out)
    assert tmp3d.out.shape == (2, 40, 48) and tmp3d.out[0].any() and not tmp3d.out[1].any()
    del tmp3d.out, jmp3d.out
    K = tgeo.camera_intrinsics(64, 48, 79.0)
    np.testing.assert_array_equal(K, jgeo.camera_intrinsics(64, 48, 79.0))
    np.testing.assert_array_equal(tgeo.pixel_to_camera((3, 40), 2.5, K),
                                  jgeo.pixel_to_camera((3, 40), 2.5, K))
    np.testing.assert_array_equal(tgeo.pixel_to_world((3, 40), 2.5, K, tf),
                                  jgeo.pixel_to_world((3, 40), 2.5, K, tf))
    for uv, dep, pose, pitch in (((20, 12), 1.5, (0.3, -0.2, 0.7), -30.0),
                                 ((5, 50), 0.1, (-1.0, 2.0, -2.5), -10.0)):
        np.testing.assert_array_equal(
            tagent.pixel_to_gps(uv, dep, (56, 64), 90.0, pose, pitch),
            jagent.pixel_to_gps(uv, dep, (56, 64), 90.0, pose, pitch))


#: the dialog run's script: a question (no digits), a pixel goal, actions,
#: STOP; then the same for the second episode
DIALOG_SCRIPT = ("where should I go now?", "12 20", "↑ → ↑", "STOP")


def dialog_episodes(mod):
    """Two planar episodes (x, y, height) through scene(2): the first with
    the scene's annotations (the evaluator's oracle NPC answers), the
    second with a pre-digested goal_info (the agent's own NPC answers; it
    keeps that goal for later episodes, as in the JAX package)."""
    region_dict, object_dict, path = scene(2)
    planar = np.asarray([[p[0], p[2], p[1]] for p in path])
    goal = next(iter(object_dict))
    base = dict(trajectory_id="t", scene_id="syn", instruction_text="find the goal",
                instruction_tokens=None, start_rotation=np.zeros(4), geodesic_distance=5.0)
    return [mod.Episode(episode_id="o", start_position=planar[1], reference_path=planar[1:],
                        extra={"object_dict": object_dict, "region_dict": region_dict,
                               "instance_id": goal, "goal_position": planar[-1].tolist()},
                        **base),
            mod.Episode(episode_id="g", start_position=planar[0], reference_path=planar,
                        extra={"goal_info": {"object": "a sofa", "room": "living room",
                                             "nearby": ["lamp"]}}, **base)]


def run_dialog(side, policy, out_dir):
    cfgs, agents, evals, sims, eps = (
        (jconfigs, jagent, jdeval, jsim, jepisodes) if side == "jax"
        else (tconfigs, tagent, tdeval, tsim, tepisodes))
    cfg = cfgs.EvalCfg(agent=cfgs.AgentCfg(model_name="dialog"),
                       env=cfgs.EnvCfg(env_type="habitat"), task=cfgs.TaskCfg(max_step=12),
                       eval_type="habitat_dialog", output_dir=str(out_dir))
    agent = agents.DialogAgent(cfg.agent, policy=policy)
    outs = []
    step = agent.step
    agent.step = lambda obs: outs.append(step(obs)) or outs[-1]
    sim = logged(sims.NavmeshFakeSim(rgb_hw=(56, 56)))
    np.random.seed(0)  # the oracle's phrase picks (np.random.choice)
    recs = evals.HabitatDialogEvaluator(cfg, sim=sim, episodes=dialog_episodes(eps),
                                        agent=agent).eval_action()
    return recs, outs, sim.action_log


def test_dialog_agent_and_evaluator_match_jax(policies, tmp_path):  # noqa: F811
    with scripted_pair(*policies, script=DIALOG_SCRIPT) as (jpol, tpol):
        ref = run_dialog("jax", jpol, tmp_path / "jax")
        ours = run_dialog("port", tpol, tmp_path / "port")
    (trecs, touts, tlog), (jrecs, jouts, jlog) = ours, ref
    assert tlog == jlog and set(tlog) <= {0, 1, 2, 3}
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert t[0].keys() == j[0].keys()
        for k in t[0]:
            np.testing.assert_array_equal(np.asarray(t[0][k]), np.asarray(j[0][k]))
    assert trecs == jrecs and [r["questions"] for r in trecs] == [1.0, 1.0]
    # the oracle NPC answered the first episode's question (a numbered route
    # description), the agent's own NPC the second's, inline
    asked = [o[0] for o in touts if o[0]["action"] == [4]]
    assert "answer" not in asked[0] and "answer" in asked[1]
    assert trecs[0]["dialogs"][0]["answer"].startswith("1. ") and "dialogs" not in trecs[1]
    assert any("goal_gps" in o[0] for o in touts)


def test_dialog_agent_builds_its_policy_on_the_gpu(monkeypatch):
    cfg = tconfigs.AgentCfg(model_name="dialog", model_settings={"device": "cpu"})
    agent = tagent.DialogAgent(cfg)
    assert agent.policy.device.type == "cpu"
    assert agent.policy.model.cfg.text.dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tagent.DialogAgent(tconfigs.AgentCfg(model_name="dialog"))


def test_registries_find_the_habitat_and_dialog_classes(tmp_path):
    """In fresh interpreters (nothing of habitat/ or dialog/ imported yet):
    Evaluator.init resolves habitat_vln, habitat_default and
    habitat_dialog; Agent.init resolves "dialog"; the evaluator and agent
    packages expose the classes lazily."""
    head = """
import sys
from internnav_tpu_torch.agent import Agent
from internnav_tpu_torch.configs import AgentCfg, EvalCfg
from internnav_tpu_torch.evaluator import Evaluator
assert not any(m.startswith(("internnav_tpu_torch.dialog", "internnav_tpu_torch.habitat"))
               for m in sys.modules)
"""
    evaluators = """
for kind in ("habitat_vln", "habitat_default", "habitat_dialog"):
    ev = Evaluator.init(EvalCfg(eval_type=kind, agent=AgentCfg(model_name="simple"),
                                output_dir=sys.argv[1]), sim=object(), episodes=[])
    print(type(ev).__name__)
import internnav_tpu_torch.evaluator as e
print(e.HabitatVLNEvaluator.__name__, e.HabitatDialogEvaluator.__name__)
"""
    agent = """
print(type(Agent.init(AgentCfg(model_name="dialog", model_settings={"device": "cpu"}))).__name__)
import internnav_tpu_torch.agent as a
print(a.DialogAgent.__name__)
"""
    out = []
    for body in (evaluators, agent):
        proc = subprocess.run([sys.executable, "-c", head + body, str(tmp_path)], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        out += proc.stdout.split()
    assert out == ["HabitatVLNEvaluator", "HabitatDefaultEvaluator", "HabitatDialogEvaluator",
                   "HabitatVLNEvaluator", "HabitatDialogEvaluator", "DialogAgent", "DialogAgent"]
