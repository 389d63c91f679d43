"""Agent-server launcher of the port (scripts/eval/start_server.py;
reference scripts/eval/start_server.py:25-46).

    python scripts/torch/start_server.py [--host 0.0.0.0] [--port 8023] [--config cfg.py]

Serves `comm.server.AgentServer`: an evaluator with `use_agent_server`
(or any `AgentClient`, the JAX package's too) sends its `AgentCfg` to
/agent/init, and the server builds the agent from it (an N1 agent from
`ckpt_path` and the JSON model_settings, on model_settings["device"]: the
GPU unless "cpu"), then steps it. With --config the host and port are
the config's agent's.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from internnav_tpu_torch.comm.server import AgentServer  # noqa: E402
from internnav_tpu_torch.configs import load_py_config  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8023)
    ap.add_argument("--config", default=None, help="optional eval config; port read from agent cfg")
    args = ap.parse_args(argv)
    host, port = args.host, args.port
    if args.config:
        cfg = load_py_config(args.config)
        host = cfg.agent.server_host or host
        port = cfg.agent.server_port or port
    AgentServer(host, port).run()


if __name__ == "__main__":
    main()
