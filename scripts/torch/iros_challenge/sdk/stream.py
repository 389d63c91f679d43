"""MJPEG preview stream for the onsite runner (reference sdk/stream.py) —
stdlib http.server instead of Flask: GET / shows the live camera frame with
the current instruction overlaid.

The port's copy of scripts/iros_challenge/sdk/stream.py."""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class PreviewStream:
    def __init__(self, env, port: int = 8090, fps: int = 10):
        self.env = env
        self.port = port
        self.fps = fps
        self.instruction = ""
        self._server = None

    def set_instruction(self, text: str) -> None:
        self.instruction = text

    def _frame(self):
        import cv2
        import numpy as np

        obs = self.env.get_observation()
        obs = obs[0] if isinstance(obs, list) else obs
        frame = np.asarray(obs["rgb"])[..., ::-1].copy()
        cv2.putText(frame, self.instruction[:80], (8, 24),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
        ok, jpg = cv2.imencode(".jpg", frame)
        return jpg.tobytes() if ok else b""

    def start(self) -> None:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    while True:
                        buf = outer._frame()
                        self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n\r\n")
                        self.wfile.write(buf + b"\r\n")
                        time.sleep(1.0 / outer.fps)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def log_message(self, *a):
                pass

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        print(f"preview stream on :{self.port}")

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
