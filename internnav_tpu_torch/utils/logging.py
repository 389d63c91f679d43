"""Per-task logger and per-trajectory progress logger (`get_logger`,
`ProgressLogger` and `_TrajRecord` of internnav_tpu/utils/logging.py, copied
so that the port imports nothing of the JAX package). The fps per
trajectory is the published metric of the progress log: steps over wall
seconds per trajectory."""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_loggers: Dict[str, logging.Logger] = {}


def get_logger(task_name: str = "internnav_tpu", log_dir: Optional[str] = None) -> logging.Logger:
    if task_name in _loggers:
        return _loggers[task_name]
    logger = logging.getLogger(task_name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{task_name}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _loggers[task_name] = logger
    return logger


@dataclass
class _TrajRecord:
    key: str
    start_time: float
    end_time: Optional[float] = None
    steps: int = 0
    result: Optional[str] = None

    @property
    def duration(self) -> float:
        end = self.end_time if self.end_time is not None else time.time()
        return max(end - self.start_time, 1e-9)

    @property
    def fps(self) -> float:
        return self.steps / self.duration


@dataclass
class ProgressLogger:
    """Per-dataset trajectory progress with fps accounting + final report."""

    name: str = "progress"
    log_dir: Optional[str] = None
    records: Dict[str, _TrajRecord] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)

    def start(self, key: str) -> None:
        self.records[key] = _TrajRecord(key=key, start_time=time.time())
        self.order.append(key)

    def step(self, key: str, n: int = 1) -> None:
        if key in self.records:
            self.records[key].steps += n

    def end(self, key: str, result: str = "done") -> None:
        rec = self.records.get(key)
        if rec is None:
            return
        rec.end_time = time.time()
        rec.result = result
        get_logger(self.name).info(
            "traj %s: %d steps in %.2fs (%.2f fps) — %s",
            key, rec.steps, rec.duration, rec.fps, result,
        )

    def report(self) -> Dict[str, float]:
        done = [r for r in self.records.values() if r.end_time is not None]
        total_steps = sum(r.steps for r in done)
        total_time = sum(r.duration for r in done)
        summary = {
            "num_trajectories": float(len(done)),
            "total_steps": float(total_steps),
            "total_time_s": total_time,
            "mean_fps": (total_steps / total_time) if total_time > 0 else 0.0,
            # per-trajectory fps — the reference's published runtime metric
            # (progress_log_multi_util.py:75-89 last_log)
            "trajectories": [
                {"key": r.key, "steps": r.steps,
                 "duration_s": round(r.duration, 4), "fps": round(r.fps, 3),
                 "result": r.result}
                for r in done
            ],
        }
        get_logger(self.name).info("progress report: %s", summary)
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, f"{self.name}_report.json"), "w") as f:
                json.dump(summary, f, indent=2)
        return summary
