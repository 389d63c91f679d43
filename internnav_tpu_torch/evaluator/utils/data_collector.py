"""Per-rank episode result store — eval-resume + trajectory collection.

Reference: internnav/evaluator/utils/data_collector.py (LMDB-backed
`sample_data{rank}.lmdb`, save_eval_result:131-151). lmdb is not available
here; the store is an append-only jsonl journal per rank with the same
semantics (done-key set, fail reasons, resumability across crashes — each
record is one fsynced line). A native C++ mmap store can back the same API
for trajectory payloads (see native/traj_store).

Copy of internnav_tpu/evaluator/utils/data_collector.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Set


class EpisodeResultStore:
    def __init__(self, root: str, rank: int = 0):
        self.root = root
        self.rank = rank
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, f"sample_data_{rank}.jsonl")
        self._done: Dict[str, Dict[str, Any]] = {}
        self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write from a crash
                self._done[rec["key"]] = rec

    def save_eval_result(self, key: str, fail_reason: str = "", info: Optional[Dict] = None) -> None:
        rec = {"key": key, "fail_reason": fail_reason, "info": info or {}}
        self._done[key] = rec
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def done_keys(self) -> Set[str]:
        return set(self._done)

    def failed_keys(self) -> Dict[str, str]:
        return {k: r.get("fail_reason", "") for k, r in self._done.items() if r.get("fail_reason")}

    def records(self) -> Iterable[Dict[str, Any]]:
        return list(self._done.values())

    @classmethod
    def all_ranks(cls, root: str) -> Iterable[Dict[str, Any]]:
        """Read every rank's journal (reference ResultLogger reads all
        per-rank LMDBs, result_logger.py:56-235)."""
        out = []
        if not os.path.isdir(root):
            return out
        for name in sorted(os.listdir(root)):
            if name.startswith("sample_data_") and name.endswith(".jsonl"):
                rank = int(name[len("sample_data_"):-len(".jsonl")])
                out.extend(cls(root, rank).records())
        return out
