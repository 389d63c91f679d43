"""Episode iteration over a trajectory store (port of
internnav_tpu/dataset/base.py): rank/world sharding of the sorted keys and
block shuffling, the batching helper, a background-thread prefetcher,
and the inflection weights of the recurrent policies' labels."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from internnav_tpu_torch.dataset.traj_store import TrajStore


class TrajectoryDataset:
    """Iterates decoded trajectory dicts from a TrajStore with rank/worker
    sharding and block shuffling."""

    def __init__(
        self,
        store_path: str,
        rank: int = 0,
        world_size: int = 1,
        shuffle_block: int = 16,
        seed: int = 0,
        filter_fn: Optional[Callable[[Dict[str, Any]], bool]] = None,
    ):
        self.store = TrajStore(store_path, writable=False)
        self.keys = sorted(self.store.keys())[rank::world_size]
        self.shuffle_block = shuffle_block
        self.seed = seed
        self.filter_fn = filter_fn
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.keys)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rs = np.random.RandomState(self.seed + self.epoch)
        keys = list(self.keys)
        # block shuffle: shuffle blocks, then within blocks
        blocks = [keys[i: i + self.shuffle_block] for i in range(0, len(keys), self.shuffle_block)]
        rs.shuffle(blocks)
        for block in blocks:
            rs.shuffle(block)
            for k in block:
                traj = self.store.get_tree(k)
                if traj is None:
                    continue
                traj["__key__"] = k
                if self.filter_fn is None or self.filter_fn(traj):
                    yield traj
        self.epoch += 1


def batch_iterator(
    sample_iter: Iterable,
    batch_size: int,
    collate_fn: Callable[[List[Any]], Dict[str, np.ndarray]],
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    batch: List[Any] = []
    for sample in sample_iter:
        batch.append(sample)
        if len(batch) == batch_size:
            yield collate_fn(batch)
            batch = []
    if batch and not drop_last:
        yield collate_fn(batch)


class Prefetcher:
    """Background-thread prefetch of host batches (depth=2 default)."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None

        def run():
            try:
                for item in iterable:
                    self.queue.put(item)
            except BaseException as e:  # surface worker errors to consumer
                self.error = e
            finally:
                self.queue.put(self._SENTINEL)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.queue.get()
            if item is self._SENTINEL:
                if self.error is not None:
                    raise self.error
                return
            yield item


def repeat_forever(make_iter: Callable[[], Iterable]) -> Iterator:
    while True:
        yield from make_iter()


def inflection_weights(actions: np.ndarray, coef: float = 3.2) -> np.ndarray:
    """Weight (1, coef) where the action differs from the previous step
    (reference cma_lmdb_dataset.py __next__ :200-221). First step weights coef."""
    actions = np.asarray(actions)
    prev = np.concatenate([[actions[0] - 1], actions[:-1]])
    return np.where(actions != prev, coef, 1.0).astype(np.float32)
