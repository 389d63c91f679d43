"""The port's agent server and client (`comm/`), its launcher
(`scripts/torch/start_server.py`) behind `scripts/torch/eval.py`, and its
two-process evaluator gather (`scripts/torch/dryrun_distributed_eval.py`),
on the CPU.

Ports of the JAX package's tests/test_server.py (on ephemeral ports, so
that parallel test runs do not collide) and of what its
tests/test_distributed_eval.py expects; a tiny "internvla_n1" agent served
over HTTP acts as the same agent in-process; the wire interoperates with
the JAX package's `AgentClient`; a request that fails is answered 500 and
the server serves the next one.
"""

import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from internnav_tpu.comm.client import AgentClient as JAgentClient
from internnav_tpu.configs import AgentCfg as JAgentCfg
from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent
from internnav_tpu_torch.comm.client import AgentClient
from internnav_tpu_torch.comm.server import AgentServer
from internnav_tpu_torch.configs import AgentCfg, load_py_config
from internnav_tpu_torch.evaluator import Evaluator
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.utils.vln_utils import S2Output
from internnav_tpu_torch.realworld import serve

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


class _Served:
    """An AgentServer on an ephemeral port, on a background thread."""

    def __init__(self, **agents):
        self.server = AgentServer("127.0.0.1", 0)
        self.server.agents.update(agents)

    def __enter__(self):
        self.thread = self.server.run(background=True)
        return self.server

    def __exit__(self, *exc):
        self.server.shutdown()
        self.thread.join(timeout=10)
        for agent in self.server.agents.values():
            getattr(agent, "close", lambda: None)()
        assert not self.thread.is_alive()


def test_server_roundtrip_simple_agent():
    with _Served() as server:
        cfg = AgentCfg(server_host="127.0.0.1", server_port=server.port,
                       model_name="simple", model_settings={"mode": "fixed", "action": 2})
        client = AgentClient(cfg, retries=5)
        obs = [{"rgb": np.zeros((4, 4, 3), np.uint8)} for _ in range(3)]
        out = client.step(obs)
        assert [o["action"] for o in out] == [[2], [2], [2]]
        client.reset([0])
        client.reset(None)


def test_server_unknown_agent_errors():
    with _Served() as server:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/agent/nope/step",
            data=json.dumps({"observation": ""}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=5)
        assert err.value.code == 404


def test_jax_client_talks_to_the_port_server():
    """The JAX package's AgentClient against the port's AgentServer: init
    over JSON, observations and actions as base64(pickle)."""
    with _Served() as server:
        cfg = JAgentCfg(server_host="127.0.0.1", server_port=server.port, model_name="simple",
                        model_settings={"mode": "random", "seed": 3, "num_actions": 4})
        client = JAgentClient(cfg, retries=5)
        obs = [{"rgb": np.zeros((4, 4, 3), np.uint8), "depth": np.ones((4, 4, 1))}] * 5
        got = [o["action"][0] for o in client.step(obs)]
        want = np.random.RandomState(3).randint(0, 4, size=5).tolist()
        assert got == want and sorted(server.agents) == ["simple"]
        client.reset(None)


def _frames(n, seed=0):
    r = np.random.default_rng(seed)
    return [{"rgb": r.integers(0, 256, (56, 56, 3)).astype(np.uint8),
             "depth": r.uniform(0, 1, (56, 56, 1)).astype(np.float32),
             "instruction_text": "go down the hall and stop at the stairs"} for _ in range(n)]


def _tiny_agent(**settings):
    policy = serve.build_policy("parity", device=torch.device("cpu"),
                                config=InternVLAN1Config.tiny())
    return InternVLAN1Agent.with_policy(policy, **settings)


def test_internvla_n1_agent_over_http_acts_as_in_process():
    """A tiny "internvla_n1" agent in the server (its config object cannot
    cross the wire as JSON: the server holds the agent, and the client's
    /agent/init finds it) against the same agent in-process on an equal
    policy: the same actions and trajectories, through a reset."""
    settings = {"async_s2": False, "sys2_max_forward_step": 3}
    local = _tiny_agent(**settings)
    with _Served(internvla_n1=_tiny_agent(**settings)) as server:
        client = AgentClient(AgentCfg(server_host="127.0.0.1", server_port=server.port,
                                      model_name="internvla_n1", model_settings=settings),
                             retries=5)
        for i, o in enumerate(_frames(7)):
            if i == 4:
                client.reset([0])
                local.reset([0])
            got, want = client.step([o])[0], local.step([o])[0]
            assert got["action"] == want["action"], i
            np.testing.assert_array_equal(got.get("trajectory"), want.get("trajectory"))
        assert "trajectory" in got


class _FlakyPolicy:
    """System-2 fails on its first call, then plans a forward action."""

    def __init__(self):
        self.calls = 0

    def reset(self):
        pass

    def s2_step(self, rgb, instruction, look_down=False):
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("flash attention kernel launch failed")
        return S2Output(output_action=[1])


@pytest.mark.parametrize("async_s2", [True, False])
def test_a_failed_step_is_a_500_and_the_server_serves_the_next(async_s2):
    agent = InternVLAN1Agent.with_policy(_FlakyPolicy(), async_s2=async_s2)
    with _Served(internvla_n1=agent) as server:
        client = AgentClient(AgentCfg(server_host="127.0.0.1", server_port=server.port,
                                      model_name="internvla_n1"), retries=5)
        obs = _frames(1)
        with pytest.raises(urllib.error.HTTPError) as err:
            client.step(obs)
        assert err.value.code == 500
        assert "kernel launch failed" in json.loads(err.value.read())["error"]
        assert client.step(obs)[0]["action"] == [1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _simple_cfg(out_dir, port=None):
    """The "simple" agent over 4 episodes of data/fake_r2r, in-process or
    (port) behind the agent server."""
    return (
        "from internnav_tpu_torch.configs import (AgentCfg, EnvCfg, EvalCfg, EvalDatasetCfg,\n"
        "                                         TaskCfg)\n"
        "eval_cfg = EvalCfg(\n"
        f"    agent=AgentCfg(model_name='simple', server_host='127.0.0.1', "
        f"server_port={port or 0},\n"
        "                   model_settings={'mode': 'random', 'seed': 1}),\n"
        "    env=EnvCfg(env_type='fake', env_num=2,\n"
        "               env_settings={'rgb_resolution': [32, 32], 'depth_resolution': [32, 32]}),\n"
        "    task=TaskCfg(max_step=10),\n"
        "    dataset=EvalDatasetCfg(base_data_dir='data/fake_r2r', max_episodes=4),\n"
        f"    eval_type='vln_batched', output_dir={str(out_dir)!r},\n"
        f"    use_agent_server={port is not None})\n")


def test_eval_cli_against_start_server(tmp_path):
    """`scripts/torch/eval.py --config` with use_agent_server against
    `scripts/torch/start_server.py` in another process: the metrics of the
    same evaluation in-process (the "simple" agent's seeded actions), one
    result.json line, and the server's /health lists the agent."""
    from torch_gloo_workers import bounded_env, run_bounded, start_bounded

    port = _free_port()
    (tmp_path / "remote.py").write_text(_simple_cfg(tmp_path / "remote", port))
    (tmp_path / "local.py").write_text(_simple_cfg(tmp_path / "local"))
    server = start_bounded([sys.executable, "scripts/torch/start_server.py", "--config",
                            str(tmp_path / "remote.py")], cwd=REPO, env=bounded_env())
    try:
        proc = run_bounded([sys.executable, "scripts/torch/eval.py", "--config",
                            str(tmp_path / "remote.py")], 120, cwd=REPO, env=bounded_env())
        assert proc.returncode == 0, proc.stderr[-3000:]
        remote = json.loads(proc.stdout.strip().splitlines()[-1])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as resp:
            assert json.loads(resp.read())["agents"] == ["simple"]
    finally:
        server.terminate()
        try:
            server.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.communicate()
    cwd = os.getcwd()
    try:
        os.chdir(REPO)
        local = Evaluator.init(load_py_config(str(tmp_path / "local.py"))).eval()
    finally:
        os.chdir(cwd)
    timings = {k for k in local if "latency" in k or k == "wall_clock_s"}
    assert remote["num_episodes"] == 4
    assert {k: v for k, v in remote.items() if k not in timings} == \
        {k: v for k, v in local.items() if k not in timings}
    with open(tmp_path / "remote" / "result.json") as f:
        assert len(f.read().splitlines()) == 1


def test_two_process_eval_gather():
    """The port's dryrun_distributed_eval.py: two gloo processes, each rank
    3 of the 6 episodes, both ranks' gathered metrics over 6, one
    result.json line (what the JAX package's tests/test_distributed_eval.py
    expects of its script)."""
    from torch_gloo_workers import bounded_env, run_bounded

    out = run_bounded([sys.executable, str(REPO / "scripts/torch/dryrun_distributed_eval.py")],
                      120, env=bounded_env())
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert lines, f"no summary line:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}"
    summary = json.loads(lines[-1])
    assert summary["ok"], summary
    assert out.returncode == 0
    assert summary["result_json"]["num_episodes"] == 6
    locals_ = summary["per_rank_local_episodes"]
    assert len(locals_) == 2 and not (set(locals_[0]) & set(locals_[1]))
    assert sorted(len(s) for s in locals_) == [3, 3]
