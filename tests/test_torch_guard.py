"""The port imports no jax, and its agent serves through the real-robot HTTP
server on the CPU (tiny policy): /reset, /eval_dual round trips, and a
System-2 failure reaching the caller as HTTP 500 instead of a STOP action.
"""

import json
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from internnav_tpu.realworld.server import RealWorldServer, encode_npy
from internnav_tpu.model.utils.vln_utils import S2Output
from internnav_tpu_torch import require_cuda
from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
from internnav_tpu_torch.realworld import serve

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "internnav_tpu_torch",
    "internnav_tpu_torch.ops.flash_attention",
    "internnav_tpu_torch.ops._build",
    "internnav_tpu_torch.model.basemodel.internvla_n1.policy",
    "internnav_tpu_torch.model.weights.from_jax",
    "internnav_tpu_torch.agent.internvla_n1_agent",
    "internnav_tpu_torch.realworld.serve",
    "internnav_tpu.realworld.server",
]


def test_port_imports_with_jax_blocked():
    """In a fresh interpreter (this one already imported jax): with jax made
    unimportable, every port module imports and neither jax nor flax loads."""
    code = ("import sys; sys.modules['jax'] = None\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "assert not any(m.split('.')[0] in ('jax', 'flax') for m in sys.modules "
              "if sys.modules[m] is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    paths = [*(REPO / "internnav_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
             *(REPO / "scripts" / "torch").glob("*.py")]
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), (path, line)


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
    policy = InternVLAN1Policy.build(InternVLAN1Config.tiny())
    with _Served(InternVLAN1Agent(policy)) as srv:
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
    with _Served(InternVLAN1Agent(_FailingPolicy(), async_s2=async_s2)) as srv:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv.port, "/eval_dual", _frame_body(0))
        assert err.value.code == 500
        assert "kernel launch failed" in json.loads(err.value.read())["error"]


def test_launcher_refuses_unported_profile_and_missing_gpu(monkeypatch):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        serve.build_policy("realtime", device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_cuda("cuda:0")


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
    agent = InternVLAN1Agent(policy, async_s2=False)
    obs = [{"rgb": np.zeros((8, 8, 3), np.uint8), "instruction_text": "go"}]
    assert agent.step(obs)[0]["action"] == [0]  # '↓' is not executed itself
    assert agent.step(obs)[0]["action"] == [1]
    assert policy.calls == [False, True]
