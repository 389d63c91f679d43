"""IROS onsite-competition runner (reference scripts/iros_challenge/
onsite_competition/sdk/main.py): interactive confirm loop — pick an
instruction, query the agent server per step, confirm each discrete action
before executing it on the real robot, MJPEG preview stream on the side.

The port's copy of scripts/iros_challenge/sdk/main.py, on the port's agent
client, configs and "realworld" env (it imports nothing of the JAX
package). `--dry-run` gives the env synthetic frames and prints each
velocity command instead of sending it to a robot base; `--max-steps`
ends an instruction after that many actions (0: never)."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[4]))

from internnav_tpu_torch.comm.client import AgentClient  # noqa: E402
from internnav_tpu_torch.configs import load_py_config  # noqa: E402
from internnav_tpu_torch.configs.evaluator import EnvCfg  # noqa: E402
from internnav_tpu_torch.env.base import Env  # noqa: E402
from internnav_tpu_torch.realworld import env as _realworld_env  # noqa: E402,F401 (registers it)

ACTION_WORDS = ["stand still", "move forward", "turn left", "turn right"]


def parse_args():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True,
                    help="eval config file exposing eval_cfg")
    ap.add_argument("--instructions", default="scripts/iros_challenge/instructions.json")
    ap.add_argument("--instruction", default=None, help="override instruction text")
    ap.add_argument("--uninteractive_mode", action="store_true",
                    help="skip per-step confirmation")
    ap.add_argument("--stream_port", type=int, default=0,
                    help="MJPEG preview port (0 = off)")
    ap.add_argument("--dry-run", action="store_true",
                    help="synthetic camera frames; velocity commands printed, not sent")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="actions per instruction before it ends (0 = until stopped)")
    return ap.parse_args()


def dry_run_io():
    """A synthetic camera and a printing command sink for the env."""
    import numpy as np

    rs = np.random.RandomState(0)

    def camera():
        return {"rgb": rs.randint(0, 255, (480, 640, 3)).astype(np.uint8),
                "depth": rs.uniform(0.1, 5.0, (480, 640)).astype(np.float32)}

    def command(v, w, duration_s):
        print(f"command: v={v:.2f} w={w:.2f} for {duration_s:.2f}s")

    return {"camera_fn": camera, "command_fn": command, "action_duration_s": 0.0}


def confirm(msg: str) -> bool:
    try:
        answer = input(f"{msg} [y/N]: ").strip().lower()
    except (EOFError, KeyboardInterrupt):
        print("\nCancelled.")
        return False
    return answer in ("", "y")


def pick_instruction(path: str) -> str:
    items = json.load(open(path))
    print("Available instructions:")
    for i, item in enumerate(items):
        print(f"{i}: {item.get('instruction_title', item)}")
    idx = int(input("input instruction id: ").strip())
    ins = items[idx]["instruction"]
    return ins[0] if isinstance(ins, list) else ins


def main() -> None:
    args = parse_args()
    cfg = load_py_config(args.config, attr="eval_cfg")
    agent = AgentClient(cfg.agent)

    settings = dict(cfg.env.env_settings)
    if args.dry_run:
        settings.update(dry_run_io())
    env = Env.init(EnvCfg(env_type="realworld", env_settings=settings), cfg.task)
    env.reset()
    stream = None
    if args.stream_port:
        from stream import PreviewStream

        stream = PreviewStream(env, port=args.stream_port)
        stream.start()

    while True:
        instruction = args.instruction or pick_instruction(args.instructions)
        print("\nNew instruction:", instruction)
        if stream:
            stream.set_instruction(instruction)
        steps = 0
        while not args.max_steps or steps < args.max_steps:
            steps += 1
            obs = env.get_observation()
            obs = dict(obs[0] if isinstance(obs, list) else obs)
            obs["instruction_text"] = instruction
            action = agent.step([obs])[0]["action"][0]
            word = ACTION_WORDS[max(0, min(3, int(action)))]
            if args.uninteractive_mode or confirm(f"Execute [{word}]?"):
                env.step([action])
            else:
                print("Stop requested; resetting agent.")
                agent.reset()
                break
        if args.instruction:
            break


if __name__ == "__main__":
    main()
