"""Agent HTTP server — stdlib ThreadingHTTPServer (no FastAPI dependency).

Port of internnav_tpu/comm/server.py (reference
internnav/utils/comm_utils/server.py:14-118): routes GET /health, POST
/agent/init, POST /agent/{name}/step, POST /agent/{name}/reset, with the
same status codes (404 for an unknown route or agent, 500 with the error
for a request that raised) and observations and actions as base64(pickle),
so the JAX package's `AgentClient` and this one talk to either server. The
server process owns the policy on the GPU; simulator processes stay on the
host and talk HTTP.

The HTTP server runs each request on a thread of its own, and an agent
holds one policy on the card (its streams, decode buffers and captured
graphs): every request to one agent (init, step, reset) holds that
agent's lock, so one agent serves one request at a time. A request that
raises is answered 500 and leaves the agent serving the next one.
"""

from __future__ import annotations

import base64
import json
import pickle
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from internnav_tpu_torch.agent.base import Agent
from internnav_tpu_torch.configs.agent import AgentCfg
from internnav_tpu_torch.utils.logging import get_logger


def serialize_obs(obs: Any) -> str:
    return base64.b64encode(pickle.dumps(obs)).decode()


def deserialize_obs(payload: str) -> Any:
    return pickle.loads(base64.b64decode(payload))


class AgentServer:
    def __init__(self, host: str = "0.0.0.0", port: int = 8023):
        self.host = host
        self.port = port
        self.agents: Dict[str, Agent] = {}
        self.logger = get_logger("agent_server")
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._locks: Dict[str, threading.Lock] = {}
        self._init_lock = threading.Lock()

    def _lock(self, name: str) -> threading.Lock:
        with self._init_lock:
            return self._locks.setdefault(name, threading.Lock())

    # ------------------------------------------------------------- handlers
    def init_agent(self, agent_config: Dict[str, Any]) -> Dict[str, Any]:
        cfg = AgentCfg.model_validate(agent_config)
        with self._lock(cfg.model_name):
            if cfg.model_name not in self.agents:
                self.agents[cfg.model_name] = Agent.init(cfg)
                self.logger.info("initialized agent %s", cfg.model_name)
        return {"status": "ok", "agent": cfg.model_name}

    def step_agent(self, name: str, payload: str) -> Dict[str, Any]:
        obs = deserialize_obs(payload)
        with self._lock(name):
            action = self.agents[name].step(obs)
        return {"status": "ok", "action": serialize_obs(action)}

    def reset_agent(self, name: str, reset_index) -> Dict[str, Any]:
        with self._lock(name):
            self.agents[name].reset(reset_index)
        return {"status": "ok"}

    # --------------------------------------------------------------- server
    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: Dict[str, Any]):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/health":
                    self._reply(200, {"status": "ok", "agents": sorted(server_self.agents)})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    parts = [p for p in self.path.split("/") if p]
                    if parts == ["agent", "init"]:
                        self._reply(200, server_self.init_agent(body["agent_config"]))
                    elif len(parts) == 3 and parts[0] == "agent" and parts[2] == "step":
                        if parts[1] not in server_self.agents:
                            self._reply(404, {"error": f"agent {parts[1]} not initialized"})
                        else:
                            self._reply(200, server_self.step_agent(parts[1], body["observation"]))
                    elif len(parts) == 3 and parts[0] == "agent" and parts[2] == "reset":
                        if parts[1] not in server_self.agents:
                            self._reply(404, {"error": f"agent {parts[1]} not initialized"})
                        else:
                            self._reply(200, server_self.reset_agent(parts[1],
                                                                     body.get("reset_index")))
                    else:
                        self._reply(404, {"error": "unknown route " + self.path})
                except Exception as e:  # surface errors to the client
                    server_self.logger.exception("request failed")
                    self._reply(500, {"error": repr(e)})

        return Handler

    def run(self, background: bool = False):
        """Serve on host:port (port 0: a free port, then `self.port`);
        with background, on a daemon thread, which is returned."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]
        self.logger.info("agent server on %s:%d", self.host, self.port)
        if background:
            t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            t.start()
            return t
        self._httpd.serve_forever()

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
