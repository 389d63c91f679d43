"""Training-loop metric smoothing and periodic logging.

Copy of internnav_tpu/utils/metric_logger.py (reference
internnav/utils/dist.py:12-144: SmoothedValue, MetricLogger), kept in the
port so that it imports nothing of the JAX package (held equal to it by
tests/test_torch_host_copies.py). The cross-process synchronize step is a
`torch.distributed` all-reduce of (count, total) when a process group is
initialised (the reference's), where JAX's gathers over its hosts; without
one it is a no-op.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist


class SmoothedValue:
    """Track a series of values with a moving window + global avg."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: Deque[float] = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self) -> None:
        """Sum count / total over the process group (no-op without one)."""
        if not (dist.is_available() and dist.is_initialized()):
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device="cuda" if dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str) -> SmoothedValue:
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def log_every(
        self, iterable: Iterable, print_freq: int, header: str = "",
        logger=None, total: Optional[int] = None,
    ) -> Iterator:
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        log = logger.info if logger is not None else print
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    log(f"{header} [{i}/{total}] eta: {eta:.0f}s {self} "
                        f"time: {iter_time} data: {data_time}")
                else:
                    log(f"{header} [{i}] {self} time: {iter_time} data: {data_time}")
            i += 1
            end = time.time()
        log(f"{header} total time: {time.time() - start:.2f}s ({i} iters)")
