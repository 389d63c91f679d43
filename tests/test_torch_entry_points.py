"""The port's own entry points of the N1 system held against the JAX
package's: `configs/loader.py`, `configs/model.py` and `configs/defaults`,
`configs/vln_default.py`, `model.get_policy` / `get_config`,
`scripts/torch/eval.py --config` over the port's configs in
scripts/torch/configs/, and the registered single-stream "internvla_n1"
agent, which acts as the JAX agent's schedule does on the same policy.
"""

import dataclasses
import inspect
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from internnav_tpu import configs as jconfigs
from internnav_tpu import model as jmodel_zoo
from internnav_tpu.agent.internvla_n1_agent import InternVLAN1Agent as JAgent
from internnav_tpu.configs.defaults import _CFGS as J_DEFAULT_NAMES
from internnav_tpu.configs.vln_default import get_config as j_vln_get_config
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch import model as tmodel_zoo
from internnav_tpu_torch.agent.base import Agent
from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent
from internnav_tpu_torch.configs.vln_default import get_config as t_vln_get_config
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
from internnav_tpu_torch.model.utils.vln_utils import S2Output, chunk_token, traj_to_actions
from internnav_tpu_torch.realworld import serve

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
#: the warm-started finetunes' and the Kujiale VLN-PE evaluation's configs,
#: which tests/test_torch_tools.py holds against their originals
TOOL_CONFIGS = ("cma_plus_cfg.py", "seq2seq_plus_cfg.py", "challenge_train_kujiale_cfg.py",
                "challenge_train_mp3d_cfg.py", "h1_cma_cfg_kujiale.py")
#: the port's eval configs (its copies of scripts/eval/configs/); the
#: train configs, `*_train_cfg.py`, copy scripts/train/configs/
PORT_CONFIGS = sorted(p for p in (REPO / "scripts" / "torch" / "configs").glob("*.py")
                      if not p.name.endswith("_train_cfg.py") and p.name not in TOOL_CONFIGS)
TRAIN_CONFIGS = sorted((REPO / "scripts" / "torch" / "configs").glob("*_train_cfg.py"))
FAKE_N1 = REPO / "scripts" / "torch" / "configs" / "fake_n1_pipelined_cfg.py"
#: what a run's metrics hold that is a time, not a result
TIMINGS = ("wall_clock_s", "action_latency_p50_ms", "action_latency_p90_ms",
           "action_latency_p99_ms", "action_latency_mean_ms")


def _config_fields(cfg) -> dict:
    """An InternVLAN1Config of either package as flat fields: dtypes by
    name, and System-1's image size resolved as each package's policy
    resolves it (JAX: None → `InternVLAN1Policy.build`'s image_hw)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in _config_fields(v).items()})
        elif f.name == "dtype":  # torch.bfloat16 / <class 'jax.numpy.bfloat16'>
            out[f.name] = str(v).split(".")[-1].strip("'>")
        else:
            out[f.name] = v
    if "s1_image_hw" in out and out["s1_image_hw"] is None:
        out["s1_image_hw"] = inspect.signature(JPolicy.build).parameters["image_hw"].default
    return out


def _dump(cfg) -> tuple:
    """(model_dump without the N1 config object, that object's fields)."""
    d = cfg.model_dump()
    n1 = cfg.agent.model_settings.get("config")
    d["agent"]["model_settings"].pop("config", None)
    return d, None if n1 is None else _config_fields(n1)


@pytest.mark.parametrize("path", PORT_CONFIGS, ids=lambda p: p.name)
def test_port_config_files_equal_jax_configs(path):
    """The fake N1 configs (each with an N1 config object), the Habitat ones,
    the VLN-PE h1 one and the recurrent policies' (none)."""
    assert [p.name for p in PORT_CONFIGS] == [
        "fake_cma_cfg.py", "fake_n1_pipelined_cfg.py", "fake_n1_shared_decode_cfg.py",
        "h1_cma_cfg.py", "h1_internvla_n1_async_cfg.py", "h1_rdp_cfg.py", "h1_seq2seq_cfg.py",
        "habitat_dialog_cfg.py", "habitat_dual_system_cfg.py", "habitat_object_cfg.py",
        "habitat_s2_cfg.py"]
    port = tconfigs.load_py_config(str(path))
    ref = jconfigs.load_py_config(str(REPO / "scripts" / "eval" / "configs" / path.name))
    assert isinstance(port, tconfigs.EvalCfg)
    pd, pn1 = _dump(port)
    rd, rn1 = _dump(ref)
    assert pd == rd
    assert pn1 == rn1
    if path.name.startswith("habitat_"):
        assert pn1 is None and pd["env"]["env_type"] == "habitat"
    elif any(m in path.name for m in ("cma", "seq2seq", "rdp")):
        assert pn1 is None and pd["eval_type"] == "vln_batched"
        assert pd["agent"]["model_name"] in ("cma", "seq2seq", "rdp")
        assert pd["env"]["env_type"] == "fake"
    elif path.name.startswith("h1_"):
        assert pn1 is None and pd["env"]["env_type"] == "internutopia"
        assert pd["eval_type"] == "vln_pe" and pd["task"]["camera_resolution"] == [640, 480]
    else:
        assert pn1["text.dtype"] == "bfloat16"


@pytest.mark.parametrize("path", TRAIN_CONFIGS, ids=lambda p: p.name)
def test_port_train_configs_equal_jax_configs(path):
    """scripts/torch/configs/{cma,seq2seq,rdp,navdp}_train_cfg.py against
    scripts/train/configs/{cma,seq2seq,rdp,navdp}_cfg.py: the same ExpCfg."""
    assert [p.name for p in TRAIN_CONFIGS] == [
        "cma_train_cfg.py", "navdp_train_cfg.py", "rdp_train_cfg.py", "seq2seq_train_cfg.py"]
    port = tconfigs.load_py_config(str(path), "exp_cfg")
    ref = jconfigs.load_py_config(str(REPO / "scripts" / "train" / "configs" /
                                      path.name.replace("_train_cfg", "_cfg")), "exp_cfg")
    assert type(port).__module__ == "internnav_tpu_torch.configs.trainer"
    assert port.model_dump() == ref.model_dump()
    assert port.il.model_fields_set == ref.il.model_fields_set  # use_ema set in rdp's, navdp's


def test_load_py_config_refuses_a_file_without_the_attribute(tmp_path):
    (tmp_path / "c.py").write_text("other = 1\n")
    for mod in (tconfigs, jconfigs):
        with pytest.raises(AttributeError, match="does not define 'eval_cfg'"):
            mod.load_py_config(str(tmp_path / "c.py"))
        assert mod.load_py_config(str(tmp_path / "c.py"), "other") == 1


@pytest.mark.parametrize("name", sorted(J_DEFAULT_NAMES))
def test_get_config_equals_jax(name):
    assert tmodel_zoo.get_config(name).model_dump() == jmodel_zoo.get_config(name).model_dump()


def test_get_config_unknown_name_raises_as_jax():
    for zoo in (tmodel_zoo, jmodel_zoo):
        with pytest.raises(KeyError, match="no default config"):
            zoo.get_config("nope")


def test_get_policy():
    from internnav_tpu_torch.model.basemodel.cma import CMAPolicy
    from internnav_tpu_torch.model.basemodel.cma_clip import CMACLIPPolicy
    from internnav_tpu_torch.model.basemodel.navdp import NavDPPolicy
    from internnav_tpu_torch.model.basemodel.rdp import RDPPolicy
    from internnav_tpu_torch.model.basemodel.seq2seq import Seq2SeqPolicy

    assert tmodel_zoo.get_policy("InternVLAN1_Policy") is InternVLAN1Policy
    assert tmodel_zoo.get_policy("internvla_n1") is InternVLAN1Policy
    for names, cls in ((("CMA_Policy", "cma"), CMAPolicy),
                       (("Seq2Seq_Policy", "seq2seq"), Seq2SeqPolicy),
                       (("RDP_Policy", "rdp"), RDPPolicy),
                       (("CMA_CLIP_Policy", "cma_clip"), CMACLIPPolicy),
                       (("NavDP_Policy", "navdp"), NavDPPolicy)):
        for name in names:
            assert tmodel_zoo.get_policy(name) is cls
            assert cls.name == jmodel_zoo.get_policy(name).name
    for zoo in (tmodel_zoo, jmodel_zoo):
        with pytest.raises(KeyError, match="unknown policy"):
            zoo.get_policy("nope")


def test_navdp_train_and_convert_entry_points_run(tmp_path, monkeypatch):
    """`scripts/torch/train.py` on a NavDP config (tiny widths, the towers
    of tests/test_torch_navdp_policy.py's `small_towers`) trains two steps
    on the CPU over a synthetic NavDP store and saves the policy;
    `scripts/torch/convert_checkpoint.py --model navdp` converts a
    reference-layout .pth to a native directory that loads to the same
    tensors."""
    import importlib.util

    from internnav_tpu_torch.dataset.navdp_dataset import write_synthetic_navdp_dataset
    from internnav_tpu_torch.model.weights.convert import navdp_reference_state_dict
    from test_torch_navdp_policy import small_towers, tiny

    def load(name):
        spec = importlib.util.spec_from_file_location(f"port_{name}",
                                                      REPO / "scripts" / "torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    store = write_synthetic_navdp_dataset(str(tmp_path / "store.bin"), n_episodes=2, T=10,
                                          hw=28)
    (tmp_path / "cfg.py").write_text(
        "from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg\n"
        "from test_torch_navdp_policy import tiny\n"
        "from internnav_tpu_torch.model import get_config\n"
        f"exp_cfg = ExpCfg(name='navdp_tiny', model_name='navdp', output_dir={str(tmp_path)!r},"
        " model=tiny(get_config), il=IlCfg(lr=1e-4))\n")
    with small_towers():
        metrics = load("train").main(["--config", str(tmp_path / "cfg.py"), "--store", store,
                                      "--steps", "2", "--batch-size", "2", "--device", "cpu"])
        pol = tmodel_zoo.get_policy("navdp").from_pretrained(str(tmp_path / "navdp_tiny_final"),
                                                             device="cpu")
    assert np.isfinite([metrics[k] for k in ("loss", "critic_loss", "aux_loss")]).all()
    assert pol.cfg.memory_size == 2 and pol.net.predict_size == 6
    torch.save(navdp_reference_state_dict(pol.net), tmp_path / "navdp.pth")
    from internnav_tpu_torch.configs import defaults

    # the converter builds the model's default config: the tiny one here
    monkeypatch.setattr(tmodel_zoo, "get_config", lambda name: tiny(defaults.get_model_cfg))
    with small_towers():
        assert load("convert_checkpoint").main([
            "--model", "navdp", "--src", str(tmp_path / "navdp.pth"), "--dst",
            str(tmp_path / "native"), "--device", "cpu"]) == 0
        back = tmodel_zoo.get_policy("navdp").from_pretrained(str(tmp_path / "native"),
                                                              device="cpu")
    for name, value in back.net.state_dict().items():
        assert torch.equal(value, pol.net.state_dict()[name]), name


def _vlnpe_cfg(mod, **task):
    task = {"robot_usd_path": "/assets/h1/h1.usd", "robot_flash": True,
            "scene": mod.SceneCfg(scene_type="kujiale", scene_data_dir="/scenes"), **task}
    return mod.EvalCfg(
        agent=mod.AgentCfg(model_name="internvla_n1", model_settings={"max_new_tokens": 16}),
        env=mod.EnvCfg(env_type="internutopia", proc_num=2),
        task=mod.TaskCfg(**task),
        dataset=mod.EvalDatasetCfg(base_data_dir="/data/r2r"),
        eval_type="vln_pe")


@pytest.mark.parametrize("task", [{}, {"robot_flash": False, "camera_resolution": [640, 480]}])
def test_vln_default_get_config_equals_jax(task):
    got = t_vln_get_config(_vlnpe_cfg(tconfigs, **task))
    want = j_vln_get_config(_vlnpe_cfg(jconfigs, **task))
    assert got.model_dump() == want.model_dump()
    assert got.agent.model_settings["system1"] == "nextdit_async"  # the model's defaults merged
    for get, mod in ((t_vln_get_config, tconfigs), (j_vln_get_config, jconfigs)):
        with pytest.raises(RuntimeError, match="unknown scene_type"):
            get(_vlnpe_cfg(mod, scene=mod.SceneCfg(scene_type="moon")))


def _start(args):
    """A python subprocess at the repo's root with PYTHONHASHSEED=0 and two
    threads (`torch_gloo_workers.bounded_env`)."""
    from torch_gloo_workers import bounded_env, start_bounded

    return start_bounded([sys.executable, *args], cwd=REPO, env=bounded_env(PYTHONHASHSEED="0"))


def _last_json(proc, deadline):
    """The last stdout line of `proc` as JSON, once it exits 0 before the
    time.monotonic() `deadline` (its process group killed past it)."""
    from torch_gloo_workers import finish

    done = finish(proc, deadline)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_eval_cli_prints_the_metrics_of_the_evaluator(tmp_path):
    """`python scripts/torch/eval.py --config <tiny N1 config> --device cpu`
    against `Evaluator.init(cfg).eval()` called directly on the same config
    and seed (both in processes of PYTHONHASHSEED=0: FakeEnv seeds its
    frames with the hash of each episode's key): the same metrics but
    their timings, and result.json holds them."""
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from internnav_tpu_torch.configs import load_py_config\n"
        f"eval_cfg = load_py_config({str(FAKE_N1)!r})\n"
        f"eval_cfg.output_dir = {str(tmp_path / 'cli')!r}\n")
    # the two runs at once, under one deadline
    procs = [_start(["scripts/torch/eval.py", "--config", str(cfg), "--device", "cpu"]),
             _start(["-c", (
                 "import json\n"
                 "from internnav_tpu_torch.configs import load_py_config\n"
                 "from internnav_tpu_torch.evaluator import Evaluator\n"
                 f"cfg = load_py_config({str(cfg)!r})\n"
                 f"cfg.output_dir = {str(tmp_path / 'direct')!r}\n"
                 "cfg.agent.model_settings['device'] = 'cpu'\n"
                 "print(json.dumps(Evaluator.init(cfg).eval()))\n")])]
    deadline = time.monotonic() + 120
    cli, direct = (_last_json(p, deadline) for p in procs)
    assert cli["num_episodes"] == 4
    assert {k: v for k, v in cli.items() if k not in TIMINGS} == \
        {k: v for k, v in direct.items() if k not in TIMINGS}
    with open(tmp_path / "cli" / "result.json") as f:
        assert json.loads(f.read().splitlines()[-1]) == cli


@pytest.mark.parametrize("model", ["cma", "seq2seq"])
def test_eval_cli_runs_the_recurrent_policies_on_the_cpu(tmp_path, model):
    """`scripts/torch/eval.py --config scripts/torch/configs/fake_cma_cfg.py
    --device cpu` (and the same with the seq2seq agent) at the reference's
    width, random weights: every episode evaluated, finite metrics,
    result.json written."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("port_eval", REPO / "scripts/torch/eval.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from internnav_tpu_torch.configs import load_py_config\n"
        f"eval_cfg = load_py_config({str(PORT_CONFIGS[0])!r})\n"
        f"eval_cfg.agent.model_name = {model!r}\n"
        f"eval_cfg.dataset.base_data_dir = {str(REPO / 'data' / 'fake_r2r')!r}\n"
        f"eval_cfg.output_dir = {str(tmp_path / 'out')!r}\n")
    got = cli.main(["--config", str(cfg), "--device", "cpu"])  # in this process: 2 threads
    assert PORT_CONFIGS[0].name == "fake_cma_cfg.py"
    assert got["num_episodes"] == 4 and np.isfinite([got[k] for k in ("success", "spl", "NE")]).all()
    assert (tmp_path / "out" / "result.json").exists()


def test_eval_cli_needs_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without a GPU the default device raises (no fallback to the host);
    eval_type vln_pe is assembled and run: with no episode at its data
    path it exits 0 before any agent is built, as the reference does ("No
    episodes found")."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("port_eval", REPO / "scripts/torch/eval.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg = tmp_path / "cfg.py"
    cfg.write_text("from internnav_tpu_torch.configs import load_py_config\n"
                   f"eval_cfg = load_py_config({str(FAKE_N1)!r})\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(cfg)])
    (tmp_path / "pe.py").write_text(
        "from internnav_tpu_torch import configs as mod\n"
        f"exec({inspect.getsource(_vlnpe_cfg)!r})\n"
        "eval_cfg = _vlnpe_cfg(mod)\n")
    with pytest.raises(SystemExit) as ended:
        cli.main(["--config", str(tmp_path / "pe.py"), "--device", "cpu"])
    assert ended.value.code == 0


def _frames(n, seed=0):
    r = np.random.default_rng(seed)
    return [{"rgb": r.integers(0, 256, (56, 56, 3)).astype(np.uint8),
             "depth": r.uniform(0, 1, (56, 56, 1)).astype(np.float32),
             "instruction_text": "walk past the sofa and stop at the door"}
            for _ in range(n)]


def _n1_settings(**kw):
    return {"config": InternVLAN1Config.tiny(), "device": "cpu", "profile": "parity",
            "async_s2": False, "sys2_max_forward_step": 3, "max_local_steps": 3, **kw}


@pytest.mark.parametrize("mode", ["partial_async", "sync"])
def test_registered_agent_acts_as_the_jax_agent_schedule(mode):
    """The "internvla_n1" agent built from an AgentCfg (its policy built
    from the settings) against the JAX package's InternVLAN1Agent driving
    an equal port policy (the seed-0 build of the same config): the same
    actions and trajectories at every step, an episode reset included."""
    settings = _n1_settings(infer_mode=mode)
    agent = Agent.init(tconfigs.AgentCfg(model_name="internvla_n1", model_settings=settings))
    assert isinstance(agent, InternVLAN1Agent) and agent.policy.device.type == "cpu"
    policy = serve.build_policy("parity", device=torch.device("cpu"),
                                config=InternVLAN1Config.tiny())
    jsettings = {k: v for k, v in settings.items() if k not in ("config", "device", "profile")}
    ref = JAgent(jconfigs.AgentCfg(model_name="internvla_n1", model_settings=jsettings), policy)
    frames = _frames(9)
    for i, o in enumerate(frames):
        if i == 6:
            agent.reset([0])
            ref.reset([0])
        got, want = agent.step([o])[0], ref.step([o])[0]
        assert got["action"] == want["action"], i
        assert ("trajectory" in got) == ("trajectory" in want), i
        if "trajectory" in got:
            np.testing.assert_array_equal(got["trajectory"], want["trajectory"])
    assert agent.policy.episode_idx == ref.policy.episode_idx > 0


def test_with_policy_is_the_registered_agent():
    """`with_policy` (RealWorldServer's, chip_smoke's) is the agent the
    registry builds, on a given policy; unknown settings raise."""
    policy = serve.build_policy("parity", device=torch.device("cpu"),
                                config=InternVLAN1Config.tiny())
    a = InternVLAN1Agent.with_policy(policy, async_s2=False, sys2_max_forward_step=2)
    assert a.policy is policy and a.cfg.model_name == "internvla_n1"
    assert (a.mode, a.sys2_max_forward_step, a.max_local_steps, a.depth_scale,
            a.depth_clip_m, a.continuous_traj, a.async_s2) == (
        "partial_async", 2, 4, 10.0, 5.0, True, False)
    with pytest.raises(ValueError, match="unknown infer_mode"):
        InternVLAN1Agent.with_policy(policy, infer_mode="full_async", async_s2=False)


class _SlowPlanner:
    """System-2 plans [1, 1, 1], except on its second call, which waits for
    `release` and plans [3]."""

    def __init__(self):
        self.calls = 0
        self.started, self.release = threading.Event(), threading.Event()

    def reset(self):
        pass

    def s2_step(self, rgb, instruction, look_down=False):
        self.calls += 1
        if self.calls == 2:
            self.started.set()
            self.release.wait(10)
            return S2Output(output_action=[3])
        return S2Output(output_action=[1, 1, 1])


def test_a_plan_in_flight_across_a_reset_is_dropped():
    """With System-2 on its thread, a plan asked for in one episode and
    finished after the agent was reset is not run in the next episode."""
    policy = _SlowPlanner()
    agent = InternVLAN1Agent.with_policy(policy, sys2_max_forward_step=1)
    obs = [{"rgb": np.zeros((8, 8, 3), np.uint8), "instruction_text": "go"}]
    try:
        assert agent.step(obs)[0]["action"] == [1]
        assert agent.step(obs)[0]["action"] == [1]  # the budget is spent: a plan is asked for
        assert policy.started.wait(10)
        release = threading.Timer(0.2, policy.release.set)
        release.start()
        agent.reset([0])  # waits for the plan in flight: the agent's policy lock
        assert agent.step(obs)[0]["action"] == [1]  # a fresh plan, not the stale [3]
        assert policy.calls == 3
        release.join(timeout=10)
    finally:
        agent.close()


def test_s1_actions_with_and_without_continuous_traj():
    """continuous_traj (the default) takes the actions of the mean
    trajectory; without it, the chunks of one sampled trajectory."""
    cfg = InternVLAN1Config.tiny()
    policy = serve.build_policy("parity", device=torch.device("cpu"), config=cfg)
    rgb = np.random.default_rng(0).integers(0, 256, (1, 2, 56, 56, 3)).astype(np.uint8)
    latent = torch.randn(1, cfg.n_query, cfg.text.hidden_size,
                         generator=torch.Generator().manual_seed(0))
    mean = policy.s1_step_latent(rgb, None, latent, num_sample_trajs=4)
    assert mean.idx == [a for a in traj_to_actions(mean.trajectory) if a][:4]
    one = policy.s1_step_latent(rgb, None, latent, num_sample_trajs=4, continuous_traj=False)
    assert one.trajectory.shape == (4, cfg.predict_step_nums, 3)
    assert one.idx in [[a for a in chunk_token(t) if a][:4] for t in one.trajectory]
