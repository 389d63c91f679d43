"""Real-robot HTTP inference server.

Copy of internnav_tpu/realworld/server.py (stdlib HTTP + numpy), kept in
the port so that it imports nothing of the JAX package.

Reference parity: scripts/realworld/http_internvla_server.py:19- — a Flask
`/eval_dual` endpoint accepting an image + depth upload, running the
dual-system agent, and returning velocity/discrete-action JSON for the
robot's onboard controller. Flask isn't installed; the stdlib
ThreadingHTTPServer serves the same route with multipart or raw-npy
payloads.

Route:
  POST /eval_dual   body: json {"instruction": str,
                               "rgb": base64(npy bytes),
                               "depth": base64(npy bytes) | null,
                               "pose": [x, y, yaw] | null}
  → {"action": [...], "v": float, "w": float, "trajectory": [[dx,dy,dyaw]...]}
  POST /reset       → {"status": "ok"}
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from internnav_tpu_torch.realworld.controllers import MPCController, trajectory_to_vw
from internnav_tpu_torch.utils.logging import get_logger


def _decode_npy(payload: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(payload)), allow_pickle=False)


def encode_npy(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode()


class RealWorldServer:
    def __init__(self, agent, host: str = "0.0.0.0", port: int = 5801):
        """agent: an InternVLAN1Agent-compatible object (step/reset)."""
        self.agent = agent
        self.host = host
        self.port = port
        self.mpc = MPCController()
        self.logger = get_logger("realworld_server")
        self._httpd: Optional[ThreadingHTTPServer] = None

    def handle_eval_dual(self, body: Dict[str, Any]) -> Dict[str, Any]:
        obs = {
            "rgb": _decode_npy(body["rgb"]),
            "instruction_text": body.get("instruction", ""),
        }
        if body.get("depth"):
            obs["depth"] = _decode_npy(body["depth"])
        out = self.agent.step([obs])[0]
        resp: Dict[str, Any] = {"action": out["action"]}
        latent_traj = None
        if out.get("trajectory") is not None:
            latent_traj = np.asarray(out["trajectory"])
        if latent_traj is not None and latent_traj.size:
            pose = body.get("pose") or [0.0, 0.0, 0.0]
            mean_traj = np.cumsum(latent_traj.mean(0)[:, :2] / 4.0, axis=0)
            v, w = trajectory_to_vw(mean_traj, pose, self.mpc)
            resp.update({"v": v, "w": w, "trajectory": latent_traj.mean(0).tolist()})
        else:
            # map the discrete action to a velocity command
            a = int(out["action"][0])
            v, w = {0: (0.0, 0.0), 1: (0.4, 0.0), 2: (0.0, 0.6), 3: (0.0, -0.6)}.get(a, (0.0, 0.0))
            resp.update({"v": v, "w": w})
        return resp

    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code, body):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if self.path == "/eval_dual":
                        self._reply(200, server_self.handle_eval_dual(body))
                    elif self.path == "/reset":
                        server_self.agent.reset()
                        self._reply(200, {"status": "ok"})
                    else:
                        self._reply(404, {"error": "unknown route"})
                except Exception as e:
                    server_self.logger.exception("request failed")
                    self._reply(500, {"error": repr(e)})

        return Handler

    def run(self, background: bool = False):
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.logger.info("realworld server on %s:%d", self.host, self.port)
        if background:
            t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            t.start()
            return t
        self._httpd.serve_forever()

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
