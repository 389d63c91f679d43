"""Agent-server smoke test (reference sdk/test_agent.py): start the server
separately (scripts/eval/start_server.py), then poke init/step/reset with a
synthetic observation.

The port's copy of scripts/iros_challenge/sdk/test_agent.py, on the port's
agent client (start the server with scripts/torch/start_server.py)."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[4]))

from internnav_tpu_torch.comm.client import AgentClient  # noqa: E402
from internnav_tpu_torch.configs import load_py_config  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    cfg = load_py_config(args.config, attr="eval_cfg")
    agent = AgentClient(cfg.agent)
    obs = {
        "rgb": np.zeros((480, 640, 3), np.uint8),
        "depth": np.zeros((480, 640), np.float32),
        "instruction_text": "move forward and stop",
        "instruction": np.zeros((200,), np.int32),
    }
    for i in range(args.steps):
        out = agent.step([obs])[0]
        print(f"step {i}: action={out['action']}")
    agent.reset()
    print("agent reset ok")


if __name__ == "__main__":
    main()
