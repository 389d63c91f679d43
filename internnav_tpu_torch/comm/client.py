"""Agent HTTP client (reference internnav/utils/comm_utils/client.py:10-56).

Port of internnav_tpu/comm/client.py: waits for the server's /health,
sends the `AgentCfg` to /agent/init (its `model_dump()` as JSON, so the
model settings must be JSON values: a server builds its policy from
`ckpt_path` and those settings), and mirrors `step` and `reset` with
observations and actions as base64(pickle): a drop-in replacement for an
in-process agent inside the evaluators.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Any, Dict, List, Optional

from internnav_tpu_torch.comm.server import deserialize_obs, serialize_obs
from internnav_tpu_torch.configs.agent import AgentCfg


class AgentClient:
    def __init__(self, cfg: AgentCfg, timeout: float = 300.0, retries: int = 30):
        self.cfg = cfg
        self.base = f"http://{cfg.server_host}:{cfg.server_port}"
        self.timeout = timeout
        self.name = cfg.model_name
        self._wait_healthy(retries)
        self._post("/agent/init", {"agent_config": cfg.model_dump()})

    def _wait_healthy(self, retries: int) -> None:
        for _ in range(retries):
            try:
                with urllib.request.urlopen(self.base + "/health", timeout=5):
                    return
            except Exception:
                time.sleep(1.0)
        raise ConnectionError(f"agent server not reachable at {self.base}")

    def _post(self, route: str, body: Dict[str, Any]) -> Dict[str, Any]:
        req = urllib.request.Request(
            self.base + route,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if out.get("error"):
            raise RuntimeError(f"agent server error on {route}: {out['error']}")
        return out

    def step(self, obs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        out = self._post(f"/agent/{self.name}/step", {"observation": serialize_obs(obs)})
        return deserialize_obs(out["action"])

    def reset(self, reset_index: Optional[List[int]] = None) -> None:
        self._post(f"/agent/{self.name}/reset", {"reset_index": reset_index})
