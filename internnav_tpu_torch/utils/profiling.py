"""Profiling and observability.

Copy of internnav_tpu/utils/profiling.py, kept in the port so that it
imports nothing of the JAX package (held equal to it by
tests/test_torch_host_copies.py): `PhaseTimer` and `TensorBoardWriter`
(a minimal tfevents scalar writer, no tensorboard dependency) are the
same code; JAX's `jax_trace` is `trace` here, a `torch.profiler` trace
written as a Chrome trace under log_dir (CPU and, where CUDA is present,
CUDA activities), and `annotate` a `torch.profiler.record_function`
range.
"""

from __future__ import annotations

import contextlib
import os
import struct
import time
from typing import Dict, Iterator, Optional

from internnav_tpu_torch.utils.logging import get_logger


class PhaseTimer:
    """Accumulating per-phase wall-clock timers (env_step / agent_step /
    reset segments the reference prints at vln_distributed_evaluator.py:
    70,146-181)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self, logger=None) -> None:
        (logger or get_logger("profiling")).info("phase timers: %s", self.summary())


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """A torch.profiler trace of the block, written to
    log_dir/trace.json (open in chrome://tracing or Perfetto)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range inside a trace (torch.profiler.record_function)."""
    import torch

    return torch.profiler.record_function(name)


# ----------------------------------------------------------- tensorboard
def _masked_crc32(data: bytes) -> int:
    import zlib

    crc = zlib.crc32(data) & 0xFFFFFFFF
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


class TensorBoardWriter:
    """Minimal TF-event-file scalar writer (no tensorboard dependency).

    Emits tfevents files readable by TensorBoard; equivalent of the
    reference's tensorboard_utils.py.
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.internnav_tpu"
        )
        self._file = open(self.path, "ab")
        self._write_event(self._event(0, file_version="brain.Event:2"))

    def _event(self, step: int, file_version: Optional[str] = None,
               tag: Optional[str] = None, value: Optional[float] = None) -> bytes:
        # hand-rolled protobuf encoding for Event / Summary messages
        def tag_bytes(field: int, wire: int) -> bytes:
            return bytes([(field << 3) | wire])

        def varint(n: int) -> bytes:
            out = b""
            while True:
                b7 = n & 0x7F
                n >>= 7
                out += bytes([b7 | (0x80 if n else 0)])
                if not n:
                    return out

        body = b""
        body += tag_bytes(1, 1) + struct.pack("<d", time.time())  # wall_time
        if file_version is not None:
            fv = file_version.encode()
            body += tag_bytes(3, 2) + varint(len(fv)) + fv
        else:
            body += tag_bytes(2, 0) + varint(step)  # step
            tg = tag.encode()
            sv = tag_bytes(1, 2) + varint(len(tg)) + tg  # Summary.Value.tag
            sv += tag_bytes(2, 5) + struct.pack("<f", float(value))  # simple_value
            summary = tag_bytes(1, 2) + varint(len(sv)) + sv  # Summary.value
            body += tag_bytes(5, 2) + varint(len(summary)) + summary  # event.summary
        return body

    def _write_event(self, body: bytes) -> None:
        header = struct.pack("<Q", len(body))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc32(header)))
        self._file.write(body)
        self._file.write(struct.pack("<I", _masked_crc32(body)))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_event(self._event(step, tag=tag, value=value))

    def close(self) -> None:
        self._file.close()
