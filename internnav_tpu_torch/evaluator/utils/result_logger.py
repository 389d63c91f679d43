"""Result aggregation across ranks/splits → json + text report.

Reference parity: ResultLogger (internnav/evaluator/utils/
result_logger.py:56-235): reads every per-rank result store, aggregates
per-split TL/NE/OSR/SR/SPL (+nDTW/steps here) into a json report and a
human-readable table.

Copy of internnav_tpu/evaluator/utils/result_logger.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional

from internnav_tpu_torch.env.metrics import aggregate_metrics
from internnav_tpu_torch.evaluator.utils.data_collector import EpisodeResultStore

COLUMNS = ["num_episodes", "success", "spl", "osr", "NE", "TL", "ndtw", "steps"]


class ResultLogger:
    def __init__(self, resume_root: str, output_dir: Optional[str] = None):
        self.resume_root = resume_root
        self.output_dir = output_dir or resume_root

    def collect(self) -> List[Dict[str, Any]]:
        return [r.get("info") or {} for r in EpisodeResultStore.all_ranks(self.resume_root)]

    def aggregate(self, split_key: str = "split") -> Dict[str, Dict[str, float]]:
        by_split: Dict[str, List[Dict]] = defaultdict(list)
        for rec in self.collect():
            if rec:
                by_split[str(rec.get(split_key, "all"))].append(rec)
        out = {split: aggregate_metrics(records) for split, records in by_split.items()}
        if len(out) > 1:
            allrec = [r for recs in by_split.values() for r in recs]
            out["all"] = aggregate_metrics(allrec)
        return out

    def report(self) -> Dict[str, Dict[str, float]]:
        agg = self.aggregate()
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "aggregate_result.json"), "w") as f:
            json.dump(agg, f, indent=2)
        with open(os.path.join(self.output_dir, "aggregate_result.txt"), "w") as f:
            f.write(self.format_table(agg))
        return agg

    @staticmethod
    def format_table(agg: Dict[str, Dict[str, float]]) -> str:
        header = f"{'split':<16}" + "".join(f"{c:>12}" for c in COLUMNS)
        lines = [header, "-" * len(header)]
        for split in sorted(agg):
            row = agg[split]
            lines.append(
                f"{split:<16}" + "".join(
                    f"{row.get(c, float('nan')):>12.3f}" for c in COLUMNS
                )
            )
        return "\n".join(lines) + "\n"
