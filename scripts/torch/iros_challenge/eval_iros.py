"""IROS on-site challenge runner (reference scripts/iros_challenge/
eval_iros.py + onsite_competition/sdk/main.py).

Interactive loop: pick an instruction, confirm, stream steps to the robot
server, with per-run result logging — the SDK surface competitors script
against. The robot side is the realworld HTTP server
(`internnav_tpu_torch.realworld.serve`).

The port's copy of scripts/iros_challenge/eval_iros.py (it imports nothing
of the JAX package). `--dry-run` sends synthetic frames instead of a
camera's; the prompts still read stdin.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from internnav_tpu_torch.realworld.server import encode_npy  # noqa: E402


def post(base: str, route: str, body: dict, timeout: float = 120.0) -> dict:
    req = urllib.request.Request(
        base + route, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def capture_frame(camera_index: int = 0):
    import cv2

    cap = cv2.VideoCapture(camera_index)
    ok, frame = cap.read()
    cap.release()
    if not ok:
        raise RuntimeError("camera capture failed")
    return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="http://127.0.0.1:5801")
    ap.add_argument("--instructions", default=None,
                    help="json file with a list of candidate instructions")
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--camera", type=int, default=0)
    ap.add_argument("--dry-run", action="store_true",
                    help="synthetic frames instead of a camera")
    args = ap.parse_args()

    candidates = ["walk forward and stop at the door"]
    if args.instructions:
        with open(args.instructions) as f:
            candidates = json.load(f)

    print("Available instructions:")
    for i, ins in enumerate(candidates):
        print(f"  [{i}] {ins}")
    choice = input("Pick instruction index (default 0): ").strip() or "0"
    instruction = candidates[int(choice)]
    if input(f"Run '{instruction}'? [y/N] ").strip().lower() != "y":
        print("aborted")
        return

    post(args.server, "/reset", {})
    results = []
    for step in range(args.max_steps):
        frame = (np.random.randint(0, 255, (224, 224, 3), np.uint8)
                 if args.dry_run else capture_frame(args.camera))
        resp = post(args.server, "/eval_dual",
                    {"instruction": instruction, "rgb": encode_npy(frame)})
        print(f"step {step}: action={resp['action']} v={resp.get('v'):.2f} "
              f"w={resp.get('w'):.2f}")
        results.append(resp)
        if resp["action"][0] == 0:
            print("STOP emitted — run complete")
            break
        time.sleep(0.1)

    out = f"iros_run_{int(time.time())}.json"
    with open(out, "w") as f:
        json.dump({"instruction": instruction, "steps": results}, f, indent=2)
    print("saved", out)


if __name__ == "__main__":
    main()
