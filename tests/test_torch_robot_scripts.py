"""The port's robot-side scripts on the CPU, headless, against the port's
servers (each bound to a free port the kernel picks, read back after the
bind):

- scripts/torch/realworld/http_internvla_client.py: `DualSystemClient`
  against `realworld.server.RealWorldServer` with a stub agent (MPC and
  PID commands, as the JAX client against the JAX server in
  tests/test_aux2.py), and `--dry-run` in-process;
- scripts/torch/iros_challenge/eval_iros.py `--dry-run` against the same
  server: the instruction picked and confirmed on stdin, frames posted
  until the agent STOPs, the run's record written;
- scripts/torch/iros_challenge/sdk/test_agent.py and sdk/main.py
  (`--dry-run --uninteractive_mode`) against `comm.server.AgentServer`
  serving the "simple" agent, and sdk/test_robot.py `--dry-run`;
- sdk/stream.py's MJPEG preview serving one frame.
"""

import importlib.util
import json
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from internnav_tpu_torch.comm.server import AgentServer
from internnav_tpu_torch.realworld.server import RealWorldServer

REPO = Path(__file__).resolve().parents[1]
TORCH_SCRIPTS = REPO / "scripts" / "torch"


def script(rel: str):
    path = TORCH_SCRIPTS / rel
    spec = importlib.util.spec_from_file_location("port_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class StubAgent:
    """Forward trajectories for `stop_after` steps, then STOP (action 0)."""

    def __init__(self, stop_after=10**9):
        self.resets, self.steps, self.stop_after = 0, 0, stop_after

    def step(self, obs):
        assert obs[0]["rgb"].dtype == np.uint8
        self.steps += 1
        if self.steps > self.stop_after:
            return [{"action": [0]}]
        dp = np.zeros((2, 4, 3))
        dp[:, :, 0] = 1.0
        return [{"action": [1], "trajectory": dp}]

    def reset(self):
        self.resets += 1


class Served:
    """A server on a free port for the test's duration."""

    def __init__(self, server):
        self.server = server

    def __enter__(self):
        self.thread = self.server.run(background=True)
        return f"http://127.0.0.1:{self.server._httpd.server_address[1]}"

    def __exit__(self, *exc):
        self.server.shutdown()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def test_realworld_client_against_the_port_server(capsys):
    client_mod = script("realworld/http_internvla_client.py")
    agent = StubAgent()
    with Served(RealWorldServer(agent, "127.0.0.1", 0)) as url:
        rgb = np.zeros((8, 8, 3), np.uint8)
        depth = np.zeros((8, 8), np.float32)
        for controller in ("mpc", "pid"):
            client = client_mod.DualSystemClient(url, "go forward", controller=controller,
                                                 timeout_s=30.0)
            client.reset()
            v, w, out = client.step(rgb, depth, (0.0, 0.0, 0.0))
            assert v > 0 and np.isfinite(w)  # the controller tracks the forward trajectory
            assert client.last_trajectory.shape == (4, 3) and out["action"] == [1]
    assert agent.resets == 2 and agent.steps == 2
    client_mod.run_dry(3, "http://unused", "go", "mpc")
    assert capsys.readouterr().out.splitlines()[-1] == "dry-run ok"


def test_eval_iros_dry_run_against_the_port_server(tmp_path, monkeypatch, capsys):
    mod = script("iros_challenge/eval_iros.py")
    agent = StubAgent(stop_after=2)
    answers = iter(["0", "y"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    monkeypatch.chdir(tmp_path)
    with Served(RealWorldServer(agent, "127.0.0.1", 0)) as url:
        monkeypatch.setattr(sys, "argv", ["eval_iros.py", "--server", url, "--dry-run",
                                          "--max-steps", "6"])
        mod.main()
    assert agent.resets == 1 and agent.steps == 3
    (record,) = tmp_path.glob("iros_run_*.json")
    run = json.loads(record.read_text())
    assert run["instruction"] == "walk forward and stop at the door"
    assert [s["action"] for s in run["steps"]] == [[1], [1], [0]]
    assert "STOP emitted" in capsys.readouterr().out


@pytest.fixture
def agent_server(tmp_path):
    """An AgentServer on a free port and an eval config file pointing the
    "simple" agent at it."""
    server = AgentServer("127.0.0.1", 0)
    with Served(server):
        cfg = tmp_path / "cfg.py"
        cfg.write_text(
            "from internnav_tpu_torch.configs import AgentCfg, EvalCfg\n"
            f"eval_cfg = EvalCfg(agent=AgentCfg(model_name='simple', server_host='127.0.0.1',"
            f" server_port={server.port}))\n")
        yield server, cfg


def test_sdk_test_agent_against_the_agent_server(agent_server, monkeypatch, capsys):
    server, cfg = agent_server
    monkeypatch.setattr(sys, "argv", ["test_agent.py", "--config", str(cfg), "--steps", "2"])
    script("iros_challenge/sdk/test_agent.py").main()
    out = capsys.readouterr().out.splitlines()
    assert out == ["step 0: action=[1]", "step 1: action=[1]", "agent reset ok"]
    assert "simple" in server.agents


def test_sdk_main_dry_run_against_the_agent_server(agent_server, monkeypatch, capsys):
    _, cfg = agent_server
    monkeypatch.setattr(sys, "argv", ["main.py", "--config", str(cfg), "--dry-run",
                                      "--uninteractive_mode", "--instruction", "go to the door",
                                      "--max-steps", "3"])
    mod = script("iros_challenge/sdk/main.py")
    mod.main()
    out = capsys.readouterr().out
    assert "New instruction: go to the door" in out
    # the reset's stop, then one forward command an action
    assert out.count("command: v=0.40 w=0.00") == 3
    answers = iter(["n"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    monkeypatch.setattr(sys, "argv", ["main.py", "--config", str(cfg), "--dry-run",
                                      "--instruction", "go"])
    mod.main()  # the first action declined: the agent resets and the run ends
    assert "Stop requested; resetting agent." in capsys.readouterr().out


def test_sdk_test_robot_dry_run(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["test_robot.py", "--dry-run"])
    script("iros_challenge/sdk/test_robot.py").main()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "camera ok: (480, 640, 3) (480, 640)"
    assert [line for line in out if line.startswith("sent:")] == [
        "sent: v=0.30 w=0.00 for 1.00s", "sent: v=0.00 w=0.40 for 1.00s",
        "sent: v=0.00 w=-0.40 for 1.00s"]


def test_sdk_preview_stream_serves_a_frame():
    stream_mod = script("iros_challenge/sdk/stream.py")

    class Env:
        def get_observation(self):
            return [{"rgb": np.full((24, 32, 3), 200, np.uint8)}]

    stream = stream_mod.PreviewStream(Env(), port=0)
    stream.start()
    try:
        stream.set_instruction("go to the door")
        port = stream._server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as resp:
            assert resp.headers["Content-Type"].startswith("multipart/x-mixed-replace")
            head = resp.read(64)
        assert head.startswith(b"--frame\r\nContent-Type: image/jpeg\r\n\r\n\xff\xd8")
    finally:
        stream.stop()
