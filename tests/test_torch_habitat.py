"""The port's Habitat VLN-CE evaluation against the JAX package's.

- Copies: `compute_all` on seeded trajectories, FakeSim and NavmeshFakeSim
  over a scripted action sequence (poses, frames, `snap_point`,
  `follow_toward`), `preprocess_depth`: exactly equal.
- `HabitatVLNEvaluator` in dual_system and system2 over NavmeshFakeSim, on
  the tiny fp32 policies of tests/test_torch_slice.py (the same numpy
  weights on both sides). Random weights emit no pixel goals or actions,
  so both policies decode through the same scripted tokenizer: its
  `encode` is `SimpleTokenizer`'s, its `decode` returns the next text of a
  script (a pixel goal, an action list, STOP), whatever the tokens; the
  decode itself runs in full. The port's System-1 is handed the noise the
  JAX policy draws (`jax_noise`, restarted at each episode's reset, as
  the JAX policy's key is). Per episode the progress.json records and the
  sim's action log are exactly equal to the JAX run's; the look-down
  capture is balanced; a second run resumes from progress.json and
  re-runs nothing.
- `HabitatDefaultEvaluator` with the "simple" agent: records equal.
- The registered "habitat" env's contract, and the errors without habitat
  (the evaluator's ImportError, the env's RuntimeError,
  scripts/torch/eval.py with the port's habitat configs).
"""

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from internnav_tpu import configs as jconfigs
from internnav_tpu.env import episodes as jepisodes
from internnav_tpu.evaluator import Evaluator as JEvaluator
from internnav_tpu.habitat import env as jhenv
from internnav_tpu.habitat import evaluator as jheval
from internnav_tpu.habitat import measures as jmeasures
from internnav_tpu.habitat import sim_adapter as jsim
from internnav_tpu.model.basemodel.internvla_n1.policy import SimpleTokenizer as JTokenizer
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch.env import episodes as tepisodes
from internnav_tpu_torch.evaluator import Evaluator as TEvaluator
from internnav_tpu_torch.habitat import env as thenv
from internnav_tpu_torch.habitat import evaluator as theval
from internnav_tpu_torch.habitat import measures as tmeasures
from internnav_tpu_torch.habitat import sim_adapter as tsim
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import SimpleTokenizer as TTokenizer
from test_torch_evaluator import episodes
from test_torch_serving_batched import jax_noise
from test_torch_slice import policies  # noqa: F401

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
HW = 56
LEGAL_ACTIONS = {0, 1, 2, 3, 5, 6}
LOOKDOWN, LOOKUP = 5, 6
#: what the scripted decode returns, call after call: a pixel goal (row
#: 12, column 20), an action list, STOP, another pixel goal
SCRIPT = ("12 20", "↑ ↑ ← ↑", "STOP", "30 8")


def scripted(base, script):
    """`base` (a SimpleTokenizer class) whose decode returns the script's
    texts in turn."""

    class Scripted(base):
        def __init__(self, vocab_size):
            super().__init__(vocab_size)
            self.decoded = 0

        def decode(self, ids):
            text = script[self.decoded % len(script)]
            self.decoded += 1
            return text

    return Scripted


@contextlib.contextmanager
def scripted_pair(jpol, tpol, script=SCRIPT):
    """The two policies with the scripted tokenizer and the port's System-1
    drawing the JAX policy's noise (its calls counted in tpol.s1_calls);
    restored on exit."""
    vocab = tpol.cfg.text.vocab_size
    saved = jpol.tokenizer, tpol.tokenizer
    jpol.tokenizer, tpol.tokenizer = scripted(JTokenizer, script)(vocab), \
        scripted(TTokenizer, script)(vocab)
    state = {}

    def reset():
        state["draw"] = jax_noise(jax.random.PRNGKey(0))
        type(tpol).reset(tpol)

    def s1_step_latent(rgb, depth, latent, num_sample_trajs=32, **kw):
        tpol.s1_calls += 1
        x_init = state["draw"]((np.asarray(rgb).shape[0] * num_sample_trajs,
                                tpol.cfg.predict_step_nums, 3))
        return type(tpol).s1_step_latent(tpol, rgb, depth, latent, num_sample_trajs,
                                         x_init=x_init, **kw)

    tpol.reset, tpol.s1_step_latent, tpol.s1_calls = reset, s1_step_latent, 0
    try:
        yield jpol, tpol
    finally:
        del tpol.reset, tpol.s1_step_latent, tpol.s1_calls
        jpol.tokenizer, tpol.tokenizer = saved


@pytest.fixture
def scripted_policies(policies):  # noqa: F811
    with scripted_pair(*policies) as pair:
        yield pair


def logged(sim):
    """The sim with every stepped action appended to sim.action_log."""
    sim.action_log = []
    step = sim.step

    def step_logged(a):
        sim.action_log.append(int(a))
        return step(a)

    sim.step = step_logged
    return sim


def assert_balanced_looks(log):
    """Every LOOKDOWN x2 is followed by LOOKUP x2 before any base move (JAX
    tests/test_habitat_contract.py:115-124)."""
    i = 0
    while i < len(log):
        if log[i] == LOOKDOWN:
            assert log[i:i + 4] == [LOOKDOWN, LOOKDOWN, LOOKUP, LOOKUP], log[i:i + 4]
            i += 4
        else:
            assert log[i] != LOOKUP, log
            i += 1


def vln_cfg(cfgs, out_dir, mode, max_step, agent="simple", eval_type="habitat_vln"):
    return cfgs.EvalCfg(agent=cfgs.AgentCfg(model_name=agent),
                        env=cfgs.EnvCfg(env_type="habitat"),
                        task=cfgs.TaskCfg(max_step=max_step), eval_type=eval_type,
                        eval_settings={"mode": mode}, output_dir=str(out_dir))


def progress(out_dir):
    with open(Path(out_dir) / "progress.json") as f:
        return [json.loads(line) for line in f if line.strip()]


def run_vln(side, policy, out_dir, mode, n_episodes, max_step, seed):
    """One HabitatVLNEvaluator run of `side` ("jax" or "port"): (metrics,
    progress.json records, the sim's action log, the sim)."""
    cfgs, Ev, sims, eps = ((jconfigs, JEvaluator, jsim, jepisodes) if side == "jax"
                           else (tconfigs, TEvaluator, tsim, tepisodes))
    sim = logged(sims.NavmeshFakeSim(rgb_hw=(HW, HW)))
    ev = Ev.init(vln_cfg(cfgs, out_dir, mode, max_step), sim=sim,
                 episodes=episodes(eps, n_episodes, seed=seed), policy=policy)
    metrics = ev.eval()
    return metrics, progress(out_dir), sim.action_log, sim


#: (mode, episodes, max_step, episode seed): system2's first episode heads
#: where the camera looks, so the scripted pixel goal snaps ahead of the
#: start and the follower walks
VLN_CASES = [("dual_system", 2, 14, 3), ("system2", 1, 16, 4)]


@pytest.mark.parametrize("mode,n_episodes,max_step,seed", VLN_CASES)
def test_vln_evaluator_matches_jax(scripted_policies, tmp_path, mode, n_episodes, max_step,
                                   seed):
    jpol, tpol = scripted_policies
    runs = [run_vln(side, pol, tmp_path / side, mode, n_episodes, max_step, seed)
            for side, pol in (("jax", jpol), ("port", tpol))]
    (jm, jrecs, jlog, jsim_), (tm, trecs, tlog, tsim_) = runs
    assert trecs == jrecs and len(trecs) == n_episodes
    assert tlog == jlog
    assert {k: v for k, v in tm.items() if k != "wall_clock_s"} == \
        {k: v for k, v in jm.items() if k != "wall_clock_s"}
    assert set(tlog) <= LEGAL_ACTIONS
    assert all(np.isfinite(v) for r in trecs for v in r.values() if isinstance(v, float))
    assert tpol.tokenizer.decoded == jpol.tokenizer.decoded >= 3
    if mode == "dual_system":
        assert_balanced_looks(tlog)
        assert LOOKDOWN in tlog and tpol.s1_calls > 0 and 0 in tlog
    else:
        assert LOOKDOWN not in tlog and tsim_.follow_calls == jsim_.follow_calls > 1
        assert tsim_.snap_calls == jsim_.snap_calls > 0
    # the resume: a second run re-runs nothing and still counts every episode
    again = logged(tsim.NavmeshFakeSim(rgb_hw=(HW, HW)))
    ev = TEvaluator.init(vln_cfg(tconfigs, tmp_path / "port", mode, max_step), sim=again,
                         episodes=episodes(tepisodes, n_episodes, seed=seed), policy=tpol)
    assert ev.eval()["num_episodes"] == n_episodes
    assert again.action_log == [] and progress(tmp_path / "port") == trecs


def test_default_evaluator_with_simple_agent_matches_jax(tmp_path):
    recs = []
    for cfgs, Ev, sims, eps, side in ((jconfigs, JEvaluator, jsim, jepisodes, "jax"),
                                      (tconfigs, TEvaluator, tsim, tepisodes, "port")):
        cfg = vln_cfg(cfgs, tmp_path / side, "dual_system", 9, eval_type="habitat_default")
        cfg.agent.model_settings = {"mode": "random", "seed": 4}
        sim = logged(sims.FakeSim(rgb_hw=(16, 16)))
        Ev.init(cfg, sim=sim, episodes=episodes(eps, 3, seed=5)).eval()
        recs.append((progress(tmp_path / side), sim.action_log))
    assert recs[1] == recs[0]
    assert len(recs[1][0]) == 3 and recs[1][1]
    assert isinstance(TEvaluator.init(vln_cfg(tconfigs, tmp_path / "p2", "dual_system", 4,
                                              eval_type="habitat_default"),
                                      sim=tsim.FakeSim(), episodes=[]),
                      theval.HabitatDefaultEvaluator)


# ------------------------------------------------------------------ copies
def test_compute_all_matches_jax():
    r = np.random.default_rng(0)
    for i in range(12):
        n = int(r.integers(1, 30))
        traj = np.cumsum(r.uniform(-0.5, 0.7, (n, 3)), axis=0)
        ref = np.cumsum(r.uniform(-1, 1.5, (int(r.integers(1, 7)), 3)), axis=0)
        geo = None if i % 3 == 0 else float(r.uniform(0.5, 9.0))
        gt = None if i % 2 else np.cumsum(r.uniform(-1, 1, (5, 3)), axis=0)
        radius = float(r.choice([3.0, 0.5, 20.0]))
        assert tmeasures.compute_all(traj, ref, geo, radius, gt) == \
            jmeasures.compute_all(traj, ref, geo, radius, gt)


@pytest.mark.parametrize("navmesh", [False, True])
def test_fake_sims_match_jax(navmesh):
    """Poses, frames, episode ends and (on the navmesh) snapped points and
    follower actions over a scripted action sequence, step by step."""
    r = np.random.default_rng(1)
    jep, tep = (episodes(m, 1, seed=7)[0] for m in (jepisodes, tepisodes))
    cls = "NavmeshFakeSim" if navmesh else "FakeSim"
    j, t = (getattr(m, cls)(rgb_hw=(24, 32), max_steps=40) for m in (jsim, tsim))
    for a, b in zip(j.reset(jep).values(), t.reset(tep).values()):
        np.testing.assert_array_equal(a, b)
    for a in [*r.choice([1, 2, 3, 5, 6], 35).tolist(), 1, 0]:
        if navmesh:
            goal = r.uniform(-3, 3, 2)
            np.testing.assert_array_equal(t.snap_point(goal), j.snap_point(goal))
            assert t.follow_toward(goal) == j.follow_toward(goal)
        jo, to = j.step(a), t.step(a)
        for key in ("rgb", "depth"):
            np.testing.assert_array_equal(to[key], jo[key])
        np.testing.assert_array_equal(t.position, j.position)
        assert (t.yaw, t.episode_over, t.steps) == (j.yaw, j.episode_over, j.steps)
        if t.episode_over:
            break
    assert t.episode_over
    assert t.planar_ccw is j.planar_ccw is True
    if navmesh:
        assert (t.snap_calls, t.follow_calls) == (j.snap_calls, j.follow_calls)


def test_preprocess_depth_matches_jax():
    d = np.random.default_rng(2).uniform(-0.2, 1.2, (9, 11, 1)).astype(np.float32)
    d[0, 0], d[1, 1], d[2, 2] = np.nan, np.inf, -np.inf
    for kw in ({}, {"scale": 3.0, "clip_m": 2.0}):
        out = theval.preprocess_depth(d, **kw)
        np.testing.assert_array_equal(out, jheval.preprocess_depth(d, **kw))
        assert out.dtype == np.float32 and np.isfinite(out).all()


# ----------------------------------------------------------- env contract
class TapeSim(tsim.FakeSim):
    """FakeSim with habitat's metric keys."""

    def get_metrics(self):
        d = float(np.linalg.norm(self.position[:2] - np.asarray(self._ep.reference_path[-1][:2])))
        return {"distance_to_goal": d, "success": float(d < 3.0), "spl": 0.5}


def test_habitat_env_registry_contract(tmp_path):
    """The registered "habitat" env: episodes in scene order, reset
    iteration, (obs, reward, done, info) steps with the sim's metrics, the
    progress.json resume skip; the same episode order as the JAX env."""
    from internnav_tpu_torch.env import Env

    eps = episodes(tepisodes, 3, seed=2)
    env = Env.init(tconfigs.EnvCfg(env_type="habitat", env_settings={"sim": TapeSim()}),
                   tconfigs.TaskCfg())
    assert isinstance(env, thenv.HabitatEnv) and env.episodes == []
    jenv = jhenv.HabitatEnv(jconfigs.EnvCfg(env_type="habitat", env_settings={
        "sim": jsim.FakeSim()}), episodes=episodes(jepisodes, 3, seed=2))
    env = thenv.HabitatEnv(tconfigs.EnvCfg(env_type="habitat"), episodes=eps, sim=TapeSim())
    assert [e.episode_id for e in env.episodes] == [e.episode_id for e in jenv.episodes]
    obs = env.reset()
    assert obs["rgb"].dtype == np.uint8 and obs["depth"].shape[-1] == 1
    obs, reward, done, info = env.step([1])
    assert (reward, done) == (0.0, False) and {"distance_to_goal", "spl"} <= set(info)
    assert env.step(0)[2]
    assert env.reset() is not None and env.reset() is not None
    assert env.reset() is None and not env.is_running
    pp = tmp_path / "progress.json"
    pp.write_text(json.dumps({"episode_id": env.episodes[0].episode_id}) + "\nnot json\n\n")
    resumed = thenv.HabitatEnv(tconfigs.EnvCfg(env_type="habitat", env_settings={
        "progress_path": str(pp), "backend": "fake"}), tconfigs.TaskCfg(
            camera_resolution=[8, 12]), episodes=eps)
    assert [e.episode_id for e in resumed.episodes] == [e.episode_id for e in env.episodes[1:]]
    assert isinstance(resumed.sim, tsim.FakeSim) and resumed.sim.rgb_hw == (8, 12)


def test_without_habitat_the_errors_are_the_jax_packages(tmp_path):
    assert importlib.util.find_spec("habitat") is None
    cfg = vln_cfg(tconfigs, tmp_path, "dual_system", 4)
    with pytest.raises(ImportError, match="habitat-sim is not installed"):
        TEvaluator.init(cfg, episodes=[])
    with pytest.raises(RuntimeError, match="habitat is not installed"):
        thenv.HabitatEnv(tconfigs.EnvCfg(env_type="habitat"), episodes=[])
    with pytest.raises(ImportError):
        tsim.HabitatSimAdapter(cfg)


@pytest.mark.parametrize("name", ["dual_system", "s2", "dialog"])
def test_eval_script_with_habitat_configs_raises_the_jax_import_error(name):
    """scripts/torch/eval.py with the port's habitat configs fails as
    scripts/eval/eval.py does with the JAX package's: habitat's
    ImportError, not "not yet ported"."""
    errors = []
    for script, cfg, extra in (("scripts/eval/eval.py", "scripts/eval/configs", []),
                               ("scripts/torch/eval.py", "scripts/torch/configs",
                                ["--device", "cpu"])):
        proc = subprocess.run([sys.executable, script, "--config",
                               f"{cfg}/habitat_{name}_cfg.py", *extra], cwd=REPO,
                              capture_output=True, text=True, timeout=300,
                              env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode != 0
        errors.append(proc.stderr.strip().splitlines()[-1])
    assert errors[1] == errors[0]
    assert errors[1].startswith("ImportError: habitat-sim is not installed")
