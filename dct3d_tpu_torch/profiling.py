"""Per-stage timers and device traces.

  * StageTimer — a copy of ``dct3d_tpu.profiling.StageTimer``
    (tests/test_torch_host.py pins it): per-stage wall seconds, bytes and
    calls, threaded through the encoders and the DEFLATE sinks (the
    ``deflate`` stage sums its seconds over the sink's pool workers),
    printed as one JSON line by ``encode --stats``;
  * trace() — a ``torch.profiler`` range named after the stage, entered
    only while a profiler runs, so traces show codec stages beside the
    kernels, on the profiler's clock, and an untraced run pays one flag
    read per span;
  * profile_to() — a ``torch.profiler`` trace of a block, written as a
    Chrome trace, ``<log_dir>/trace.json`` (``encode/decode
    --profile-dir``): operators and stage ranges of every thread (the
    encoders' drainers, the DEFLATE, inflate and entropy pools each on
    their own row) and the card's kernels when CUDA is available.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_END = object()


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

    def add_bytes(self, name: str, nbytes: int) -> None:
        """Count bytes to a stage that learns its size only inside it."""
        with self._lock:
            self.bytes[name] += nbytes

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


def trace(name: str):
    """A torch.profiler range while any profiler runs in the process, else
    a no-op context.  The test is the autograd profiler's process-wide
    flag, which every thread reads as set: the per-thread
    ``torch._C._autograd._profiler_enabled()`` reads False on a worker
    thread even while a profile follows all threads."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def traced(name: str, fn, *args):
    """``fn(*args)`` inside ``trace(name)``: a pool task with its span."""
    with trace(name):
        return fn(*args)


def traced_iter(name: str, iterable):
    """Yield ``iterable``'s items, each wait for the next one inside
    ``trace(name)``."""
    it = iter(iterable)
    while True:
        with trace(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def _all_threads_config():
    """The profiler option that records every thread's ranges, or None
    when the installed torch lacks it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def profile_to(log_dir: str | None):
    """Trace the block into ``log_dir/trace.json`` (Chrome trace format,
    viewable in Perfetto or chrome://tracing), every thread's ranges on
    the clock of the kernels; with a torch that cannot follow other
    threads, the calling thread's only (said on stderr).  No-op when
    log_dir is None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    config = _all_threads_config()
    if config is None:
        print("note: this torch profiles the calling thread only; worker "
              "threads' stages are in --stats", file=sys.stderr)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=config) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
