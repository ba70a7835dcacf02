"""Per-stage timers and device traces.

  * StageTimer — a copy of ``dct3d_tpu.profiling.StageTimer``
    (tests/test_torch_host.py pins it): per-stage wall seconds, bytes and
    calls, threaded through the encoder, printed as one JSON line by
    ``encode --stats``;
  * trace() — a ``torch.profiler`` range named after the stage, so traces
    show codec stages beside the kernels;
  * profile_to() — a ``torch.profiler`` trace of a block, written as a
    Chrome trace, ``<log_dir>/trace.json`` (``encode/decode
    --profile-dir``): the calling thread's operators and stage ranges, and
    the card's kernels from every thread when CUDA is available (the
    profiler does not follow the encoder's drainer threads on the host;
    their stages are in StageTimer).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

import torch


class StageTimer:
    """Thread-safe accumulator of per-stage seconds / bytes / calls."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = defaultdict(float)
        self.bytes: dict[str, int] = defaultdict(int)
        self.calls: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            with trace(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += dt
                self.bytes[name] += nbytes
                self.calls[name] += 1

    def as_dict(self) -> dict:
        with self._lock:
            return {
                name: {
                    "seconds": round(self.seconds[name], 4),
                    "bytes": self.bytes[name],
                    "calls": self.calls[name],
                    "mb_per_s": round(
                        self.bytes[name] / self.seconds[name] / 1e6, 2
                    ) if self.seconds[name] and self.bytes[name] else None,
                }
                for name in sorted(self.seconds)
            }

    def report(self) -> str:
        return json.dumps(self.as_dict())


@contextlib.contextmanager
def trace(name: str):
    """A torch.profiler range (a few microseconds when no trace runs)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str | None):
    """Trace the block into ``log_dir/trace.json`` (Chrome trace format,
    viewable in Perfetto or chrome://tracing).  No-op when log_dir is
    None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
