"""The port imports nothing of JAX or of the JAX package, its copies of the
JAX package's host-side modules equal their originals, and its agent
serves through the port's real-robot HTTP server on the CPU (tiny policy):
/reset, /eval_dual round trips, and a System-2 failure reaching the caller
as HTTP 500 instead of a STOP action.
"""

import dataclasses
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from internnav_tpu.model.utils import vln_utils as jvln
from internnav_tpu.realworld import controllers as jctrl
from internnav_tpu.utils import geometry as jgeo
from internnav_tpu_torch import require_cuda
from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
from internnav_tpu_torch.model.utils import vln_utils as tvln
from internnav_tpu_torch.model.utils.vln_utils import S2Output
from internnav_tpu_torch.realworld import controllers as tctrl
from internnav_tpu_torch.realworld import serve
from internnav_tpu_torch.realworld.server import RealWorldServer, encode_npy
from internnav_tpu_torch.utils import geometry as tgeo
from internnav_tpu_torch.utils.logging import get_logger

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
PORT_SOURCES = [*(REPO / "internnav_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
                *(REPO / "scripts" / "torch").rglob("*.py")]
#: the port's bench entry of the evaluator path (a script, not a module)
BENCH_ENTRY = REPO / "scripts" / "torch" / "bench_evaluator.py"
#: the port's entry scripts and config files that the guard loads as files
#: with jax blocked (each script's main runs only as __main__)
SCRIPTS = [BENCH_ENTRY, *(REPO / "scripts" / "torch" / name for name in (
    "eval.py", "start_server.py", "dryrun_distributed_eval.py",
    "configs/fake_n1_pipelined_cfg.py", "configs/fake_n1_shared_decode_cfg.py",
    "configs/h1_internvla_n1_async_cfg.py",
    *(f"configs/habitat_{name}_cfg.py" for name in ("dual_system", "s2", "dialog", "object")),
    "configs/fake_cma_cfg.py", "configs/h1_cma_cfg.py", "configs/h1_seq2seq_cfg.py",
    "convert_checkpoint.py"))]
#: every module of the port, by its file
PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in (REPO / "internnav_tpu_torch").rglob("*.py"))
#: an import of the JAX package or of jax / flax, in any form
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|flax|internnav_tpu)(\.|\s|$|,)")


def test_port_modules_cover_the_package():
    assert "internnav_tpu_torch.trainer.internvla_n1_trainer" in PORT_MODULES
    assert "internnav_tpu_torch.realworld.server" in PORT_MODULES
    assert "internnav_tpu_torch.dataset.traj_store" in PORT_MODULES
    for mod in ("env.fake_env", "env.episodes", "env.metrics", "env.controllers",
                "evaluator.base", "evaluator.vln_evaluator", "evaluator.vln_pipelined_evaluator",
                "evaluator.utils.data_collector", "evaluator.utils.latency", "configs.agent",
                "configs.evaluator", "agent.base", "utils.registry", "graft_entry",
                # the NavDP System-1 (head, RGBD backbone, DDPM scheduler)
                "model.basemodel.internvla_n1.navdp_head", "model.encoder.navdp_backbone",
                "model.encoder.transformer", "model.encoder.vit", "ops.schedulers",
                # sharded training and the EMA
                "parallel", "parallel.collectives", "parallel.mesh", "parallel.tp",
                "parallel.fsdp", "trainer.ema",
                # the entry points: configs, the model factory, the agents the
                # server builds, the agent server and its client
                "configs.loader", "configs.model", "configs.defaults", "configs.vln_default",
                "model", "agent.simple_agent", "comm", "comm.server", "comm.client",
                # the Habitat VLN-CE and VL-LN dialog evaluation
                "habitat", "habitat.measures", "habitat.sim_adapter", "habitat.env",
                "habitat.evaluator", "dialog", "dialog.oracle", "dialog.npc", "dialog.mp3d",
                "dialog.dialog_agent", "dialog.evaluator", "utils.geometry", "ops.rope",
                # the VLN-PE protocol (InternUtopia) and the VN evaluator
                "env.checkers", "env.occupancy", "env.task_gen", "env.internutopia",
                "env.internutopia.loco", "env.internutopia.vec_env",
                "env.internutopia.proc_pool", "env.internutopia.env",
                "env.internutopia.isaac_ext", "env.internutopia.batch_adapter",
                "evaluator.utils.result_logger", "evaluator.utils.visualize",
                "evaluator.vln_pe_evaluator", "evaluator.utils.planners",
                "evaluator.vn_evaluator",
                # the recurrent VLN policies (CMA, Seq2Seq), their agents,
                # and the rest of the host-only copies
                "ops.rnn", "model.encoder.rnn_state", "model.encoder.instruction",
                "model.encoder.resnet", "model.base", "model.basemodel.cma",
                "model.basemodel.seq2seq", "agent.recurrent_agent", "utils.misc",
                "utils.metric_logger", "utils.profiling", "realworld.env", "realworld.agilex",
                "dataset.vlln_dataset"):
        assert f"internnav_tpu_torch.{mod}" in PORT_MODULES, mod
    assert set(SCRIPTS) <= set(PORT_SOURCES)
    assert len(PORT_MODULES) > 40
    assert not any(m.split(".")[0] != "internnav_tpu_torch" for m in PORT_MODULES)


def test_port_imports_with_jax_blocked():
    """In a fresh interpreter (this one already imported jax): with jax and
    internnav_tpu made unimportable, every port module, the bench entry and
    the other entry scripts and config files load and neither jax, flax nor
    internnav_tpu loads."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['internnav_tpu'] = None\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "import importlib.util\n"
            + "".join(f"spec = importlib.util.spec_from_file_location('script{i}', {str(p)!r})\n"
                      "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
                      for i, p in enumerate(SCRIPTS))
            + "assert not any(m.split('.')[0] in ('jax', 'flax', 'internnav_tpu') "
              "for m in sys.modules if sys.modules[m] is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_int8_modules_import_without_triton(tmp_path, monkeypatch):
    """The int8 kernels are CUDA C++ built by nvcc on first use: with triton
    unimportable and no CUDA device, the int8 ops and the text model import,
    every int8 dispatcher runs its plain version on the CPU, and triton is
    never loaded. Each kernel library is named by a hash of its source (an
    edited source builds anew)."""
    code = ("import sys; sys.modules['triton'] = None\n"
            "import torch\n"
            "from internnav_tpu_torch.ops import quant\n"
            "from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text\n"
            "assert not torch.cuda.is_available()\n"
            "x = torch.ones(2, 64, dtype=torch.bfloat16)\n"
            "outs = [*quant.rmsnorm_quantize(x, torch.ones(64), 1e-6, residual=x)[:2],\n"
            "        *quant.swiglu_quantize(x, x), *quant.quantize_activations(x)]\n"
            "assert [t.dtype for t in outs] == [torch.int8, torch.float32] * 3\n"
            "ke, ve = [(torch.zeros(1, 4, 1, 64, dtype=torch.int8), torch.zeros(1, 4, 1, 1))\n"
            "          for _ in range(2)]\n"
            "cos = torch.ones(1, 1, 64)\n"
            "q = quant.rope_kv_write(x[:1], x[:1], x[:1], cos, cos * 0, ke, ve,\n"
            "                        torch.zeros(1, dtype=torch.long))\n"
            "assert q.shape == (1, 1, 1, 64) and int(ke[0][0, 0].abs().max()) == 127\n"
            "assert 'triton' not in [m for m in sys.modules if sys.modules[m] is not None]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    from internnav_tpu_torch.ops import _build

    for src in ("quantize_rows.cu", "rope_kv_write.cu"):
        assert _build.library_path(src).name.startswith(src.removesuffix(".cu") + "_")
    shutil.copytree(_build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    for src in ("quantize_rows.cu", "rope_kv_write.cu"):
        before = _build.library_path(src)
        (tmp_path / "csrc" / src).write_text((tmp_path / "csrc" / src).read_text() + "\n")
        assert _build.library_path(src) != before


def test_port_sources_never_import_jax():
    for bad in ("import jax", "from jax.numpy import x", "import internnav_tpu",
                "import internnav_tpu.ops", "from internnav_tpu import ops",
                "    from internnav_tpu.realworld.server import RealWorldServer", "import flax"):
        assert FORBIDDEN_IMPORT.match(bad), bad
    assert not FORBIDDEN_IMPORT.match("from internnav_tpu_torch.ops import rope")
    for path in PORT_SOURCES:
        for line in path.read_text().splitlines():
            assert not FORBIDDEN_IMPORT.match(line), (path, line)
    # nor bench.py, whose functions import the JAX package
    assert not re.search(r"^\s*(import|from)\s+bench\b", BENCH_ENTRY.read_text(), re.M)


# ------------------------------------------------- copies equal originals
def test_vln_utils_copy_equals_jax_original():
    text = "go <image>\n now <image>. then\nstop"
    assert tvln.split_and_clean(text) == jvln.split_and_clean(text)
    assert tvln.parse_actions("↑ ← STOP → ↓ x") == jvln.parse_actions("↑ ← STOP → ↓ x")
    r = np.random.default_rng(0)
    steps = r.uniform(-0.3, 0.3, (12, 3))
    assert tvln.chunk_token(steps) == jvln.chunk_token(steps)
    dp = r.standard_normal((8, 16, 3)) * [1.0, 0.4, 0.2] + [0.8, 0, 0]
    assert tvln.traj_to_actions(dp) == jvln.traj_to_actions(dp)
    np.testing.assert_array_equal(tvln.traj_to_actions(dp, use_discrete_action=False),
                                  jvln.traj_to_actions(dp, use_discrete_action=False))
    path = np.cumsum(r.uniform(0, 0.3, (20, 2)), axis=0)
    assert (tvln.trajectory_to_discrete_actions(path)
            == jvln.trajectory_to_discrete_actions(path))
    for name in ("S1Input", "S1Output", "S2Input", "S2Output"):
        assert repr(getattr(tvln, name)()) == repr(getattr(jvln, name)())
    assert tvln.S2Output(output_action=[1]).validate() and not tvln.S2Output().validate()


def test_geometry_and_controller_copies_equal_jax_originals():
    r = np.random.default_rng(1)
    a = r.uniform(-10, 10, 50)
    np.testing.assert_array_equal(tgeo.wrap_angle(a), jgeo.wrap_angle(a))
    pos, cur, yaw = r.standard_normal((9, 2)), r.standard_normal(2), 0.7
    np.testing.assert_array_equal(tgeo.to_local_coords(pos, cur, yaw),
                                  jgeo.to_local_coords(pos, cur, yaw))
    np.testing.assert_array_equal(tgeo.yaw_rotmat(yaw), jgeo.yaw_rotmat(yaw))
    for q in [*r.standard_normal((20, 4)), np.array([0.5, 0.5, 0.5, 0.5]), np.zeros(4)]:
        assert tgeo.yaw_from_quat_wxyz(q) == jgeo.yaw_from_quat_wxyz(q)
        np.testing.assert_array_equal(tgeo.quat_to_euler_angles(q), jgeo.quat_to_euler_angles(q))
        np.testing.assert_array_equal(tgeo.quat_to_euler_angles(q, degrees=True),
                                      jgeo.quat_to_euler_angles(q, degrees=True))
    for y in a[:10]:
        np.testing.assert_array_equal(tgeo.quat_wxyz_from_yaw(y), jgeo.quat_wxyz_from_yaw(y))
    traj = np.cumsum(r.uniform(0, 0.2, (10, 2)), axis=0)
    pose = (0.3, -0.2, 0.4)
    assert tctrl.trajectory_to_vw(traj, pose) == jctrl.trajectory_to_vw(traj, pose)
    assert tctrl.MPCController().step(pose, traj) == jctrl.MPCController().step(pose, traj)
    tp, jp = tctrl.PIDController(), jctrl.PIDController()
    for target in traj[:4]:
        assert tp.step(pose, target) == jp.step(pose, target)


def test_logger_copy_configures_like_the_original(tmp_path):
    from internnav_tpu.utils.logging import get_logger as jget_logger

    ours = get_logger("port_copy_check", str(tmp_path))
    theirs = jget_logger("jax_copy_check", str(tmp_path))
    assert ours is get_logger("port_copy_check")
    assert (ours.level, ours.propagate, len(ours.handlers)) == (
        theirs.level, theirs.propagate, len(theirs.handlers))
    assert (tmp_path / "port_copy_check.log").exists()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, route, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _frame_body(seed):
    r = np.random.default_rng(seed)
    return {"instruction": "go to the chair",
            "rgb": encode_npy(r.integers(0, 256, (56, 56, 3)).astype(np.uint8)),
            "depth": encode_npy(r.uniform(0, 1, (56, 56, 1)).astype(np.float32))}


class _Served:
    def __init__(self, agent):
        self.agent = agent
        self.port = _free_port()
        self.server = RealWorldServer(agent, "127.0.0.1", self.port)

    def __enter__(self):
        self.thread = self.server.run(background=True)
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.thread.join(timeout=10)
        self.agent.close()
        assert not self.thread.is_alive()


def test_agent_round_trip_through_server():
    policy = InternVLAN1Policy.build(InternVLAN1Config.tiny(), device="cpu")
    with _Served(InternVLAN1Agent.with_policy(policy)) as srv:
        assert _post(srv.port, "/reset", {}) == (200, {"status": "ok"})
        for seed in range(2):
            code, resp = _post(srv.port, "/eval_dual", _frame_body(seed))
            assert code == 200
            traj = np.asarray(resp["trajectory"])
            assert traj.shape == (8, 3) and np.isfinite(traj).all()
            assert np.isfinite([resp["v"], resp["w"]]).all()


class _FailingPolicy:
    def reset(self):
        pass

    def s2_step(self, *args, **kwargs):
        raise RuntimeError("flash attention kernel launch failed")


@pytest.mark.parametrize("async_s2", [True, False])
def test_s2_failure_reaches_caller_as_500(async_s2):
    with _Served(InternVLAN1Agent.with_policy(_FailingPolicy(), async_s2=async_s2)) as srv:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv.port, "/eval_dual", _frame_body(0))
        assert err.value.code == 500
        assert "kernel launch failed" in json.loads(err.value.read())["error"]


def _jax_launcher():
    import importlib.util

    path = REPO / "scripts" / "realworld" / "http_internvla_server.py"
    spec = importlib.util.spec_from_file_location("jax_rw_launcher", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launcher_refuses_unported_profile_and_missing_gpu(monkeypatch):
    """The launcher serves the JAX launcher's profiles (realtime by
    default, no others); the int4 and W8A16 formats build, int4 through
    build_policy's weight_dtype; no GPU raises."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config as Cfg

    assert serve.PROFILES == _jax_launcher().PROFILES
    assert serve.build_policy.__defaults__ == ("realtime",)
    with pytest.raises(ValueError, match="unknown profile"):
        serve.build_policy("fp8", device=torch.device("cpu"))
    assert Cfg.qwen25vl_7b(weight_dtype="int4").text.weight_dtype == "int4"
    w16 = dataclasses.replace(Cfg.qwen25vl_7b(weight_dtype="int8").text, decode_act_dtype="bf16")
    assert w16.decode_bf16_act
    tiny = Cfg.tiny()
    pol = serve.build_policy("realtime", device=torch.device("cpu"), config=tiny,
                             weight_dtype="int4")
    lm = pol.model.language_model
    assert lm.cfg.weight_dtype == "int4" and lm.cfg.kv_dtype == "int8"
    assert lm.layers[0].self_attn.q_proj.weight_bits == 4 and lm.lm_head.weight_bits == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_cuda("cuda:0")


def test_public_constructors_default_to_the_gpu(monkeypatch):
    """`build_model`, `InternVLAN1Policy.build`, the dialog agent, the H1
    loco controller, the loco checkpoint conversion, the VLN-PE vec env
    with its loco actors, `CMAPolicy.build` / `Seq2SeqPolicy.build` and
    the "cma" / "seq2seq" agents without a device run on the GPU: with no
    CUDA device they raise instead of building on the host."""
    from internnav_tpu_torch.configs import AgentCfg
    from internnav_tpu_torch.dialog.dialog_agent import DialogAgent
    from internnav_tpu_torch.env.internutopia.loco import H1SpeedController, convert_loco_policy
    from internnav_tpu_torch.env.internutopia.vec_env import FakePhysicsVecEnv
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InternVLAN1Policy.build(InternVLAN1Config.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(InternVLAN1Config.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DialogAgent(AgentCfg(model_name="dialog"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H1SpeedController()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FakePhysicsVecEnv([], use_loco=True)
    FakePhysicsVecEnv([], use_loco=False)  # no actor, no device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_loco_policy("unread.pt")
    from internnav_tpu_torch.agent.recurrent_agent import CmaAgent, Seq2SeqAgent
    from internnav_tpu_torch.model import get_config, get_policy

    for name, agent_cls in (("cma", CmaAgent), ("seq2seq", Seq2SeqAgent)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_policy(name).build(get_config(name))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            agent_cls(AgentCfg(model_name=name))


class _LookDownPolicy:
    """S2 answers '↓' (look down) once, then a forward action."""

    def __init__(self):
        self.calls = []

    def reset(self):
        pass

    def s2_step(self, rgb, instruction, look_down=False):
        self.calls.append(look_down)
        return S2Output(output_action=[5] if len(self.calls) == 1 else [1])


def test_look_down_action_forces_an_immediate_look_down_replan():
    policy = _LookDownPolicy()
    agent = InternVLAN1Agent.with_policy(policy, async_s2=False)
    obs = [{"rgb": np.zeros((8, 8, 3), np.uint8), "instruction_text": "go"}]
    assert agent.step(obs)[0]["action"] == [0]  # '↓' is not executed itself
    assert agent.step(obs)[0]["action"] == [1]
    assert policy.calls == [False, True]
