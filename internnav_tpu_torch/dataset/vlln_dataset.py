"""VL-LN (dialog / IIGN) SFT dataset.

Copy of internnav_tpu/dataset/vlln_dataset.py over the port's
`dataset/base.py` and `internvla_n1_dataset.py`, kept in the port so that
it imports nothing of the JAX package (held equal to it by
tests/test_torch_host_copies.py). The port's TrajStore writes through on
every put, so the writer has no sync or close to call.

Reference parity: internnav/dataset/vlln_lerobot_dataset.py (VLLNDataset:
56-783) — dialog-annotated trajectories where episodes carry NPC Q/A turns
interleaved with navigation; mined into multi-turn chat samples (user
observation → assistant question → user NPC answer → assistant actions),
mixable with the plain VLN SFT stream (reference CombinedDataset:1334-1368).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from internnav_tpu_torch.dataset.base import TrajectoryDataset
from internnav_tpu_torch.dataset.internvla_n1_dataset import (
    N1Sample,
    N1SampleDataset,
    SYSTEM_PROMPT,
)


class VLLNSampleDataset:
    """Yields dialog-aware N1Samples. Episode records additionally carry:
    - dialog: list of {"t": step, "question": str, "answer": str}
    """

    def __init__(self, store_path: str, rank: int = 0, world_size: int = 1,
                 num_history: int = 4, seed: int = 0):
        self.ds = TrajectoryDataset(store_path, rank, world_size, seed=seed)
        self.num_history = num_history

    def __iter__(self) -> Iterator[N1Sample]:
        arrows = {0: "STOP", 1: "↑", 2: "←", 3: "→"}
        for traj in self.ds:
            rgb = np.asarray(traj["rgb"])
            actions = np.asarray(traj["actions"], np.int32)
            dialog = traj.get("dialog") or []
            if isinstance(dialog, (bytes, str)):
                import json

                dialog = json.loads(dialog)
            by_t: Dict[int, Dict] = {int(d["t"]): d for d in dialog}
            instruction = traj.get("instruction_text", "find the goal")
            T = rgb.shape[0]
            for t in range(T):
                images = rgb[max(0, t - self.num_history + 1): t + 1]
                prompt = SYSTEM_PROMPT.format(instruction=instruction)
                prompt += " " + "<image>" * images.shape[0]
                if t in by_t:
                    # question turn: supervise asking, then an answer-
                    # conditioned action turn
                    q = by_t[t]["question"]
                    a = by_t[t]["answer"]
                    yield N1Sample(images=images, prompt=prompt, answer=q)
                    prompt_a = prompt + f" The resident replied: {a}."
                    seq = "".join(arrows[x] for x in actions[t: t + 4])
                    yield N1Sample(images=images, prompt=prompt_a, answer=seq)
                else:
                    seq = "".join(arrows[x] for x in actions[t: t + 4])
                    yield N1Sample(images=images, prompt=prompt, answer=seq)


class CombinedDataset:
    """Round-robin mix of sample streams with integer weights
    (reference CombinedDataset:1334-1368)."""

    def __init__(self, datasets: List, weights: Optional[List[int]] = None):
        self.datasets = datasets
        self.weights = weights or [1] * len(datasets)

    def __iter__(self):
        iters = [iter(d) for d in self.datasets]
        alive = [True] * len(iters)
        while any(alive):
            for i, (it, w) in enumerate(zip(iters, self.weights)):
                if not alive[i]:
                    continue
                for _ in range(w):
                    try:
                        yield next(it)
                    except StopIteration:
                        alive[i] = False
                        break


def write_synthetic_vlln_dataset(path: str, n_episodes: int = 2, T: int = 8,
                                 hw: int = 28, seed: int = 0) -> str:
    import json

    from internnav_tpu_torch.dataset.traj_store import TrajStore

    rs = np.random.RandomState(seed)
    store = TrajStore(path, writable=True)
    for i in range(n_episodes):
        t = rs.randint(5, T + 1)
        dialog = [{"t": int(rs.randint(1, t)),
                   "question": "which room is it in?",
                   "answer": "It is in the kitchen."}]
        store.put_tree(f"ep{i:04d}", {
            "rgb": rs.randint(0, 255, (t, hw, hw, 3)).astype(np.uint8),
            "actions": rs.randint(0, 4, t).astype(np.int32),
            "instruction_text": f"find the chair {i}",
            "dialog": json.dumps(dialog),
        })
    return path
