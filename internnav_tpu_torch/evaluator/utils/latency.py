"""Per-action latency percentiles for the batched/pipelined evaluators.

The reference's only published speed observable is per-trajectory fps
(internnav/utils/progress_log_multi_util.py:82-84). BASELINE.md names
p50 per-step latency, which neither that log nor the mean fps exposes —
this tracker records the emission-to-emission wall time of every action
each live stream takes and reports p50/p90/p99/mean. In a batched
cohort all live streams of a macro-step share one delta (they step in
lockstep), so each macro-step contributes `live` samples of the same
value — exactly the latency each episode experienced.

Copy of internnav_tpu/evaluator/utils/latency.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class ActionLatencyTracker:
    """Call ``mark(live_streams)`` after every macro-step apply."""

    def __init__(self) -> None:
        self._last: Optional[float] = None
        self.samples: List[float] = []

    def start(self) -> None:
        self._last = time.perf_counter()

    def mark(self, live_streams: int) -> None:
        now = time.perf_counter()
        if self._last is not None and live_streams > 0:
            self.samples.extend([now - self._last] * int(live_streams))
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        import numpy as np

        s = np.asarray(self.samples, np.float64) * 1e3  # ms
        return {
            "action_latency_p50_ms": round(float(np.percentile(s, 50)), 2),
            "action_latency_p90_ms": round(float(np.percentile(s, 90)), 2),
            "action_latency_p99_ms": round(float(np.percentile(s, 99)), 2),
            "action_latency_mean_ms": round(float(s.mean()), 2),
            "actions_timed": int(s.size),
        }


class CohortLatencyTracker:
    """One tracker per cohort, merged at summary time: cohorts interleave
    on one chip, so each cohort's stream-experienced latency is tracked
    against its own previous macro-step, not the global clock."""

    def __init__(self, n: int) -> None:
        self.trackers = [ActionLatencyTracker() for _ in range(n)]

    def start(self, idx: int) -> None:
        self.trackers[idx].start()

    def mark(self, idx: int, live_streams: int) -> None:
        self.trackers[idx].mark(live_streams)

    def summary(self) -> Dict[str, float]:
        merged = ActionLatencyTracker()
        for t in self.trackers:
            merged.samples.extend(t.samples)
        return merged.summary()
