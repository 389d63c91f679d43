"""Robot base smoke test (reference sdk/test_robot.py): send a forward and
both turns through the command sink and read one camera frame.

The port's copy of scripts/iros_challenge/sdk/test_robot.py, on the
port's agilex camera and base controller. `--dry-run` swaps in a
synthetic camera and a printing command sink, for a machine without a
RealSense or ROS."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[4]))

from internnav_tpu_torch.realworld.agilex import AlignedRealSense, RosBaseController  # noqa: E402


class _DryCamera:
    def start(self):
        pass

    def capture(self):
        import numpy as np

        return {"rgb": np.zeros((480, 640, 3), np.uint8),
                "depth": np.ones((480, 640), np.float32)}

    def stop(self):
        pass


class _DryBase:
    def command(self, v, w, duration_s):
        print(f"sent: v={v:.2f} w={w:.2f} for {duration_s:.2f}s")


def main() -> None:
    dry = "--dry-run" in sys.argv[1:]
    cam = _DryCamera() if dry else AlignedRealSense()
    cam.start()
    frame = cam.capture()
    print("camera ok:", frame["rgb"].shape, frame["depth"].shape)
    base = _DryBase() if dry else RosBaseController()
    for name, (v, w) in (("forward", (0.3, 0.0)), ("left", (0.0, 0.4)),
                         ("right", (0.0, -0.4))):
        print("command:", name)
        base.command(v, w, duration_s=1.0)
    cam.stop()


if __name__ == "__main__":
    main()
