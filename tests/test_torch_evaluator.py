"""The port's evaluator path (`VLNPipelinedEvaluator` over `FakeEnv`,
driving `BatchedInternVLAN1Agent` cohorts on one `BatchedN1Policy` inner)
against the JAX package's, and the host-only modules the port copied.

- The evaluators: the pipelined one at 2 cohorts x 3 streams, max_step 12,
  the tiny fp32 model (the same numpy weights on both sides,
  `model/weights/from_jax`), with the shared decode on and off, the shared
  System-1 on and off, and the barrier and the overlapped env apply
  (`CASES`), over the same episodes; the batched one (no cohorts) over 3
  streams. Each port cohort
  draws its System-1 noise through `noise_fn`, which hands it the JAX
  cohort's draws (every JAX cohort's key chain starts at PRNGKey(0)).
  Per episode the actions taken and the metrics are exactly equal; the
  trajectories the agents return agree at atol/rtol 1e-4 (fp32, another
  summation order). Each JAX evaluator runs once, in a module fixture.
- The copies: FakeEnv's observations and metrics on seeded episodes, the
  progress logger, the latency trackers, the resume store and the config
  schemas equal their originals.
- One process: rank 0 of 1 and the local list back from the gather, with
  no process group.
- No silent fallback: the remote agent, a shared pool that the agents
  cannot take, a cohort agent with no policy to share and an env type that
  is not ported each raise. (The navdp System-1 is held against the JAX
  evaluator in tests/test_torch_navdp_serving.py.)
"""

import json
import time

import numpy as np
import pytest
import torch

import jax

from internnav_tpu import configs as jconfigs
from internnav_tpu.agent.internvla_n1_agent import BatchedInternVLAN1Agent as JAgent
from internnav_tpu.env import episodes as jepisodes
from internnav_tpu.env import fake_env as jfake
from internnav_tpu.env import metrics as jmetrics
from internnav_tpu.evaluator import vln_evaluator as jvln
from internnav_tpu.evaluator import vln_pipelined_evaluator as jpipe
from internnav_tpu.evaluator.utils import data_collector as jstore
from internnav_tpu.evaluator.utils import latency as jlatency
from internnav_tpu.model.basemodel.internvla_n1 import model as jmodel
from internnav_tpu.model.basemodel.internvla_n1 import serving as jserving
from internnav_tpu.utils import logging as jlogging
from internnav_tpu.utils import registry as jregistry
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch.agent.internvla_n1_agent import BatchedInternVLAN1Agent as TAgent
from internnav_tpu_torch.env import episodes as tepisodes
from internnav_tpu_torch.env import fake_env as tfake
from internnav_tpu_torch.env import metrics as tmetrics
from internnav_tpu_torch.evaluator import base as tbase
from internnav_tpu_torch.evaluator import vln_evaluator as tvln
from internnav_tpu_torch.evaluator import vln_pipelined_evaluator as tpipe
from internnav_tpu_torch.evaluator.utils import data_collector as tstore
from internnav_tpu_torch.evaluator.utils import latency as tlatency
from internnav_tpu_torch.model.basemodel.internvla_n1 import serving as tserving
from internnav_tpu_torch.utils import logging as tlogging
from internnav_tpu_torch.utils import registry as tregistry
from test_torch_serving_batched import build_pair, jax_noise
from test_torch_system1 import F32NextDiTConfig

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
COHORTS, STREAMS, MAX_STEP, HW, NEW_TOKENS = 2, 3, 12, 56, 6


def episodes(mod, n, seed=0):
    """n seeded R2R-style episodes built with `mod`'s Episode: reference
    paths of 3-6 points, a start yaw, instructions of their own."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(r.integers(3, 7))
        ref = np.cumsum(r.uniform(-1.0, 2.0, (k, 3)) * [1.0, 1.0, 0.0], axis=0)
        out.append(mod.Episode(
            episode_id=str(i), trajectory_id=f"t{i}", scene_id=f"scene{i % 2}",
            instruction_text=f"walk past the {['sofa', 'table', 'door'][i % 3]} and stop {i}",
            instruction_tokens=r.integers(1, 50, int(r.integers(2, 9))).astype(np.int32),
            start_position=np.r_[ref[0, :2], 0.0],
            start_rotation=np.asarray([float(r.uniform(-3, 3))]),
            reference_path=ref, geodesic_distance=float(np.linalg.norm(ref[-1] - ref[0]))))
    return out


#: the pipelined evaluator's settings under test: (shared_decode,
#: shared_s1, overlap_apply), by id
CASES = {"shared_decode": (True, False, False), "per_cohort_decode": (False, False, False),
         "shared_decode_overlap": (True, False, True), "shared_both_overlap": (True, True, True),
         "shared_s1": (False, True, False)}


def eval_cfg(cfgs, out_dir, shared_decode, shared_s1=False, overlap_apply=False,
             eval_type="vln_pipelined"):
    settings = {"batch_size": STREAMS, "max_new_tokens": NEW_TOKENS, "num_sample_trajs": 4,
                "sys2_max_forward_step": 4, "max_local_steps": 2}
    return cfgs.EvalCfg(
        agent=cfgs.AgentCfg(model_name="internvla_n1_batched", model_settings=settings),
        env=cfgs.EnvCfg(env_type="fake", env_num=STREAMS,
                        env_settings={"rgb_resolution": [HW, HW], "depth_resolution": [HW, HW],
                                      "cohorts": COHORTS, "shared_decode": shared_decode,
                                      "shared_s1": shared_s1, "overlap_apply": overlap_apply}),
        task=cfgs.TaskCfg(max_step=MAX_STEP), eval_type=eval_type, output_dir=str(out_dir))


def record_steps(monkeypatch, mod):
    """Every macro-step's agent output, by episode: path_key → [(action,
    trajectory or None)], for the slots live when it was taken."""
    steps = {}
    apply = mod._Cohort.apply

    def recorded(self, agent_out):
        for o, a in zip(self.obs_list, agent_out):
            if o is not None and not o.get("done", False):
                steps.setdefault(o["path_key"], []).append(
                    (a["action"][0], None if a.get("trajectory") is None
                     else np.asarray(a["trajectory"], np.float64)))
        return apply(self, agent_out)

    monkeypatch.setattr(mod._Cohort, "apply", recorded)
    return steps


def record_agent_steps(agent):
    """The batched evaluator's agent outputs by episode, as `record_steps`
    (fake observations of finished or warming slots carry no path key)."""
    steps = {}
    step = agent.step

    def recorded(batch):
        out = step(batch)
        for o, a in zip(batch, out):
            if "path_key" in o and not o.get("done", False):
                steps.setdefault(o["path_key"], []).append(
                    (a["action"][0], None if a.get("trajectory") is None
                     else np.asarray(a["trajectory"], np.float64)))
        return out

    agent.step = recorded
    return steps


def run_jax(jpol, tmp, case):
    with pytest.MonkeyPatch.context() as mp:
        cfg = eval_cfg(jconfigs, tmp / f"jax_{case}", *CASES.get(case, (False,)),
                       eval_type="vln_batched" if case == "batched" else "vln_pipelined")
        agent = JAgent(cfg.agent, policy=jserving.BatchedN1Policy(
            jpol.model, jpol.params, jpol.cfg, STREAMS, inner=jpol))
        if case == "batched":
            steps = record_agent_steps(agent)
            ev = jvln.VLNBatchedEvaluator(cfg, episodes=episodes(jepisodes, 7), agent=agent)
        else:
            steps = record_steps(mp, jpipe)
            ev = jpipe.VLNPipelinedEvaluator(cfg, episodes=episodes(jepisodes, 7), agent=agent)
        metrics = ev.eval()
    return metrics, {r["key"]: r["info"] for r in ev.store.records()}, steps


class _JaxNoiseEvaluator(tpipe.VLNPipelinedEvaluator):
    """Each cohort's System-1 noise drawn as a JAX cohort draws it."""

    def _make_cohort_agent(self, idx):
        agent = super()._make_cohort_agent(idx)
        agent.policy.noise_fn = jax_noise(jax.random.PRNGKey(0))
        return agent


def run_port(tpol, tmp, case, monkeypatch):
    cfg = eval_cfg(tconfigs, tmp / f"port_{case}", *CASES.get(case, (False,)),
                   eval_type="vln_batched" if case == "batched" else "vln_pipelined")
    policy = tserving.BatchedN1Policy(tpol, STREAMS)
    policy.noise_fn = jax_noise(jax.random.PRNGKey(0))
    agent = TAgent(cfg.agent, policy=policy)
    if case == "batched":
        steps = record_agent_steps(agent)
        ev = tvln.VLNBatchedEvaluator(cfg, episodes=episodes(tepisodes, 7), agent=agent)
    else:
        steps = record_steps(monkeypatch, tpipe)
        ev = _JaxNoiseEvaluator(cfg, episodes=episodes(tepisodes, 7), agent=agent)
    metrics = ev.eval()
    return metrics, {r["key"]: r["info"] for r in ev.store.records()}, steps


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "NextDiTConfig", F32NextDiTConfig)
        yield build_pair()


@pytest.fixture(scope="module")
def jax_runs(pair, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_eval")
    return {case: run_jax(pair[0], tmp, case) for case in (*CASES, "batched")}


def assert_runs_equal(port, ref):
    """Per-episode metrics and actions exactly equal, trajectories within
    ATOL/RTOL, the aggregate metrics (but wall time and latency) equal."""
    (tm, trecs, tsteps), (jm, jrecs, jsteps) = port, ref
    assert len(trecs) == 7 and sorted(trecs) == sorted(jrecs)
    assert trecs == jrecs  # per-episode metrics, exactly
    assert sorted(tsteps) == sorted(jsteps)
    kinds = set()
    for key, want in jsteps.items():
        got = tsteps[key]
        assert [a for a, _ in got] == [a for a, _ in want], key
        for (_, t), (_, j) in zip(got, want):
            assert (t is None) == (j is None)
            if j is not None:
                np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)
                kinds.add("trajectory")
        kinds.update(a for a, _ in got)
    assert "trajectory" in kinds  # System-1 ran
    same = {k for k in jm if k != "wall_clock_s" and not k.startswith("action_latency")}
    assert {k: tm[k] for k in same} == {k: jm[k] for k in same}


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_evaluator_matches_jax(pair, jax_runs, tmp_path, monkeypatch, case):
    assert_runs_equal(run_port(pair[1], tmp_path, case, monkeypatch), jax_runs[case])


def test_batched_evaluator_matches_jax(pair, jax_runs, tmp_path, monkeypatch):
    """`VLNBatchedEvaluator.eval_action`, the loop without cohorts: one
    batched agent over one FakeEnv of STREAMS slots."""
    assert_runs_equal(run_port(pair[1], tmp_path, "batched", monkeypatch), jax_runs["batched"])


# ------------------------------------------------------- host-only copies
def test_fake_env_copy_equals_original():
    """Observations, poses and per-episode metrics over seeded actions,
    through slot resets, to every slot's end."""
    def make(mod, cfgs, eps):
        return mod.FakeEnv(cfgs.EnvCfg(env_type="fake", env_num=3,
                                       env_settings={"rgb_resolution": [40, 48]}),
                           cfgs.TaskCfg(max_step=9), episodes=eps)

    tenv, jenv = make(tfake, tconfigs, episodes(tepisodes, 5, 3)), \
        make(jfake, jconfigs, episodes(jepisodes, 5, 3))
    r = np.random.default_rng(4)
    obs = (tenv.reset(), jenv.reset())
    while jenv.is_running and any(o is not None for o in obs[1]):
        for t, j in zip(*obs):
            assert (t is None) == (j is None)
            if j is not None:
                assert sorted(t) == sorted(j)
                for k in j:
                    np.testing.assert_array_equal(t[k], j[k])
        acts = r.choice(4, 3, p=[0.1, 0.5, 0.2, 0.2]).tolist()
        obs = (tenv.step(acts), jenv.step(acts))
        done = [i for i, o in enumerate(obs[1]) if o is not None and o["done"]]
        if done:
            obs = (tenv.reset(done), jenv.reset(done))
    assert len(jenv.results) == 5
    assert json.dumps(tenv.results) == json.dumps(jenv.results)
    np.testing.assert_array_equal(tenv.active_mask(), jenv.active_mask())


def test_metrics_and_episode_copies_equal_originals(tmp_path):
    r = np.random.default_rng(5)
    path, ref = np.cumsum(r.uniform(-1, 1, (9, 3)), 0), np.cumsum(r.uniform(-1, 1, (5, 3)), 0)
    for name in ("dtw_distance", "ndtw", "simplified_ndtw"):
        assert getattr(tmetrics, name)(path, ref) == getattr(jmetrics, name)(path, ref)
    per = [{"success": 1.0, "spl": 0.5, "NE": 1.0, "osr": 1.0, "TL": 3.0, "ndtw": 0.4,
            "steps": 7}, {"success": 0.0, "spl": 0.0, "NE": float("inf"), "steps": 3}]
    assert tmetrics.aggregate_metrics(per) == jmetrics.aggregate_metrics(per)
    raw = [{"episode_id": i, "trajectory_id": i, "scene_id": "s", "instruction": {
        "instruction_text": f"go {i}", "instruction_tokens": [1, 2]},
        "reference_path": ref.tolist(), "info": {"has_stairs": i == 1}} for i in range(3)]
    f = tmp_path / "val.json"
    f.write_text(json.dumps({"episodes": raw}))
    t = tepisodes.load_r2r_episodes(str(f), filter_stairs=True)
    j = jepisodes.load_r2r_episodes(str(f), filter_stairs=True)
    assert [e.path_key for e in t] == [e.path_key for e in j] == ["s_0_0", "s_2_2"]
    assert [e.geodesic_distance for e in t] == [e.geodesic_distance for e in j]
    assert [e.path_key for e in tepisodes.shard_episodes(tepisodes.group_by_scene(t), 1, 2)] \
        == [e.path_key for e in jepisodes.shard_episodes(jepisodes.group_by_scene(j), 1, 2)]


def test_progress_logger_copy_equals_original(tmp_path, monkeypatch):
    clock = iter(np.arange(100.0, 200.0, 0.25))
    now = {}

    def fake_time():
        now["t"] = next(clock)
        return now["t"]

    monkeypatch.setattr(time, "time", fake_time)
    reports = []
    for mod, name in ((tlogging, "port_progress"), (jlogging, "jax_progress")):
        log = mod.ProgressLogger(name=name, log_dir=str(tmp_path / name))
        log.start("a")
        log.start("b")
        log.step("a", 3)
        log.step("b")
        log.end("a", "success")
        log.step("c")  # unknown keys are ignored
        log.end("b")
        reports.append((log.report(), json.loads(
            (tmp_path / name / f"{name}_report.json").read_text())))
    assert reports[0] == reports[1]
    assert reports[0][0]["trajectories"][0] == {
        "key": "a", "steps": 3, "duration_s": 0.5, "fps": 6.0, "result": "success"}


def test_latency_tracker_copies_equal_originals(monkeypatch):
    ticks = [0.0, 0.010, 0.025, 0.026, 0.060, 0.100, 0.130]
    summaries = []
    for mod in (tlatency, jlatency):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        c = mod.CohortLatencyTracker(2)
        c.start(0)
        c.start(1)
        c.mark(0, 3)
        c.mark(1, 2)
        c.mark(0, 0)
        c.mark(1, 1)
        c.mark(0, 2)
        summaries.append((c.summary(), mod.ActionLatencyTracker().summary()))
    assert summaries[0] == summaries[1]
    assert summaries[0][0]["actions_timed"] == 8


def test_result_store_copy_resumes_like_original(tmp_path):
    for mod, sub in ((tstore, "port"), (jstore, "jax")):
        s = mod.EpisodeResultStore(str(tmp_path / sub), rank=1)
        s.save_eval_result("a", info={"success": 1.0})
        s.save_eval_result("b", fail_reason="exceed_max_step", info={"steps": np.int64(9)})
        with open(s.path, "a") as f:
            f.write('{"key": "torn')  # a crash mid-write
    t, j = (mod.EpisodeResultStore(str(tmp_path / sub), rank=1)
            for mod, sub in ((tstore, "port"), (jstore, "jax")))
    assert t.done_keys() == j.done_keys() == {"a", "b"}
    assert t.failed_keys() == j.failed_keys() == {"b": "exceed_max_step"}
    assert t.records() == j.records()
    assert tstore.EpisodeResultStore.all_ranks(str(tmp_path / "port")) == \
        jstore.EpisodeResultStore.all_ranks(str(tmp_path / "jax"))
    eps = (episodes(tepisodes, 3), episodes(jepisodes, 3))
    for e in (*eps[0], *eps[1]):
        e.scene_id, e.trajectory_id = "s", "t"
    t.save_eval_result("s_t_1", fail_reason="collision")
    j.save_eval_result("s_t_1", fail_reason="collision")
    pend = [mod.ResumableEpisodeLoader(e, store=s, retry_list=["collision"]).pending()
            for mod, e, s in ((tepisodes, eps[0], t), (jepisodes, eps[1], j))]
    assert [e.path_key for e in pend[0]] == [e.path_key for e in pend[1]] == ["s_t_0", "s_t_1",
                                                                            "s_t_2"]


@pytest.mark.parametrize("name", ["AgentCfg", "InitRequest", "StepRequest", "ResetRequest",
                                  "SensorCfg", "ControllerCfg", "RobotCfg", "SceneCfg",
                                  "MetricCfg", "TaskCfg", "EvalDatasetCfg", "EnvCfg", "EvalCfg"])
def test_config_copies_have_the_originals_fields_and_defaults(name):
    t, j = getattr(tconfigs, name), getattr(jconfigs, name)
    assert list(t.model_fields) == list(j.model_fields)
    assert t.model_config == j.model_config
    samples = {"agent_config": {"model_name": "internvla_n1_batched"}, "observation": "e30="}
    required = {k: samples[k] for k, f in j.model_fields.items() if f.is_required()}
    assert t(**required).model_dump() == j(**required).model_dump()


def test_config_helpers_equal_originals():
    over = {"env": {"env_num": 4}, "task": {"max_step": 30, "metric_config": {
        "success_distance": 2.0}}, "agent": {"model_name": "internvla_n1_batched"}}
    defaults = {"env": {"env_type": "fake", "env_settings": {"cohorts": 2}},
                "task": {"max_step": 10, "warm_up_step": 3}, "output_dir": "o"}
    t = tconfigs.merge_defaults(tconfigs.EvalCfg.model_validate(over), defaults)
    j = jconfigs.merge_defaults(jconfigs.EvalCfg.model_validate(over), defaults)
    assert t.model_dump() == j.model_dump()
    for mod, cfg in ((tconfigs, t), (jconfigs, j)):
        mod.validate_eval_config(cfg, ["env.env_type", "task.metric_config.success_distance"])
        with pytest.raises(ValueError, match="dataset.base_data_dir"):
            mod.validate_eval_config(cfg, ["dataset.base_data_dir"])


def test_registry_copy_equals_original():
    for mod in (tregistry, jregistry):
        reg = mod.Registry("thing")

        @reg.register("a")
        class A:
            pass

        assert reg.get("a") is A and A.registered_name == "a" and "a" in reg
        assert list(reg.names()) == ["a"]
        with pytest.raises(ValueError, match="already registered"):
            reg.register("a")(type("B", (), {}))
        with pytest.raises(KeyError, match="unknown thing 'b'"):
            reg.get("b")


# ---------------------------------------------------------- one process
def test_rank_world_and_gather_without_a_process_group(tmp_path):
    assert not torch.distributed.is_initialized()
    assert tbase.get_rank_world() == (0, 1)
    cfg = eval_cfg(tconfigs, tmp_path, False)
    ev = tbase.Evaluator(cfg, env=object(), agent=object())
    assert (ev.rank, ev.world_size) == (0, 1)
    local = [{"episode_id": "0", "NE": np.float64(1.5)}]
    assert ev.gather_results(local) is local


# ------------------------------------------------------ no silent fallbacks
def test_remote_agent_is_not_replaced_by_a_local_one(tmp_path):
    """With use_agent_server the evaluator's agent is an AgentClient of the
    server at the config's host and port, as in the JAX package, never an
    agent built in-process."""
    from internnav_tpu_torch.comm.client import AgentClient
    from internnav_tpu_torch.comm.server import AgentServer

    server = AgentServer("127.0.0.1", 0)
    server.agents["internvla_n1_batched"] = object()  # served already: init builds nothing
    thread = server.run(background=True)
    try:
        cfg = eval_cfg(tconfigs, tmp_path, False).model_copy(update={"use_agent_server": True})
        cfg.agent.server_host, cfg.agent.server_port = "127.0.0.1", server.port
        ev = tbase.Evaluator(cfg, env=object())
        assert isinstance(ev.agent, AgentClient)
        assert ev.agent.base == f"http://127.0.0.1:{server.port}"
    finally:
        server.shutdown()
        thread.join(timeout=10)


class _NotDualSystem:
    def __init__(self, cfg=None, policy=None):
        self.cfg, self.policy = cfg, policy

    def reset(self, ids=None):
        pass


@pytest.mark.parametrize("setting", ["shared_decode", "shared_s1"])
def test_shared_pool_with_agents_that_cannot_take_it_raises(tmp_path, setting):
    cfg = eval_cfg(tconfigs, tmp_path, False)
    cfg.env.env_settings[setting] = True
    ev = tpipe.VLNPipelinedEvaluator(cfg, episodes=episodes(tepisodes, 4),
                                     agent=_NotDualSystem(policy=object()))
    with pytest.raises(ValueError, match=setting):
        ev.eval()


def test_cohort_agent_is_never_built_without_a_policy_to_share(tmp_path):
    """A second cohort's agent comes from cohort 0's shared policy only:
    with none, the evaluator raises instead of building a model of its
    own through the agent registry."""
    ev = tpipe.VLNPipelinedEvaluator(eval_cfg(tconfigs, tmp_path, False),
                                     episodes=episodes(tepisodes, 4),
                                     agent=_NotDualSystem(policy=object()))
    with pytest.raises(ValueError, match="none to share"):
        ev.eval()


@pytest.mark.parametrize("eval_type", ["vln_batched", "vln_pipelined"])
def test_unported_env_type_is_not_replaced_by_the_fake_env(tmp_path, eval_type):
    """The batched evaluator builds FakeEnv alone (VLN-PE runs through
    "vln_pe" or the pipelined evaluator's internutopia cohorts); the
    pipelined one has no default cohort env for habitat."""
    cfg = eval_cfg(tconfigs, tmp_path, False, eval_type=eval_type)
    cfg.env.env_type = "internutopia" if eval_type == "vln_batched" else "habitat"
    with pytest.raises(NotImplementedError,
                       match="env_type 'internutopia'.*'vln_pe'|env_type='habitat'"):
        tbase.Evaluator.init(cfg, episodes=episodes(tepisodes, 4),
                             agent=_NotDualSystem(policy=object()))


def test_agent_without_a_policy_asks_for_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TAgent(tconfigs.AgentCfg(model_name="internvla_n1_batched"))
