"""The profiler over a sub-window of a traced run, and its reduction.

``Profiler`` is the benchmark's own copy of the program's ``profile_to``
wrapper (torch.profiler, CPU and CUDA activity, Chrome trace), started
before operation ``first`` of the window and stopped after ``count``
operations.  ``Trace`` reads the exported trace: the device's activity
(kernels, copies and fills, from every thread), the spans that the
benchmark and the program open with ``record_function`` on the calling
thread, and the host operators there.  Times are microseconds.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_PORT_KERNEL = re.compile(r"dct3d::(?:\(anonymous namespace\)::)?(\w+)")


def span(name: str):
    """A named range in the trace (a few microseconds when none runs)."""
    return torch.profiler.record_function(name)


def port_symbol(kernel_name: str) -> str | None:
    """The function name of a kernel of the port (namespace dct3d), or None
    for a library's kernel."""
    m = _PORT_KERNEL.search(kernel_name)
    return m.group(1) if m else None


def merge(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(x, y) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            total += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


class Trace:
    """``devices``: how many cards the run uses (0, 1, ...); busy times are
    the mean over them."""

    def __init__(self, events: list[dict], devices: int = 1) -> None:
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.device = [(e["ts"], e["ts"] + e["dur"], e["name"], e["cat"]) for e in dev]
        self.devices = devices
        ids = [e.get("args", {}).get("device", 0) for e in dev]
        self._unions = [merge((a, b) for (a, b, _, _), i in zip(self.device, ids) if i == d)
                        for d in range(devices)]
        self._kernel_unions = [
            merge((a, b) for (a, b, _, c), i in zip(self.device, ids) if i == d and c == "kernel")
            for d in range(devices)]
        marks = [e for e in xs if e.get("cat") == "user_annotation"]
        bench = [e for e in marks if e["name"].startswith("bench.")]
        self.main_tid = bench[0]["tid"] if bench else None
        self.marks = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in marks
                            if e["tid"] == self.main_tid)
        self.ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                          if e.get("cat") == "cpu_op" and e["tid"] == self.main_tid)
        ops = [(a, b) for a, b, n in self.marks if n == "bench.op"]
        self.window = (min(a for a, _ in ops), max(b for _, b in ops)) if ops else (0.0, 0.0)
        self.busy_union = merge((a, b) for a, b, _, _ in self.device)

    def spans(self, name: str) -> list[tuple[float, float]]:
        return merge((a, b) for a, b, n in self.marks if n == name)

    def busy(self, merged, kernels_only: bool = False) -> float:
        """Device-busy microseconds inside ``merged``, the mean over the
        run's cards."""
        unions = self._kernel_unions if kernels_only else self._unions
        return sum(overlap(u, merged) for u in unions) / max(1, self.devices)

    def kernels_in(self, merged) -> list[tuple[float, float, str]]:
        """Kernel events whose midpoint lies inside ``merged``."""
        starts = [a for a, _ in merged]
        out = []
        for a, b, name, cat in self.device:
            mid = (a + b) / 2
            k = bisect.bisect_right(starts, mid) - 1
            if cat == "kernel" and k >= 0 and mid <= merged[k][1]:
                out.append((a, b, name))
        return out

    def _innermost(self, items, t: float) -> str | None:
        k = bisect.bisect_right(items, (t, float("inf"), "")) - 1
        for a, b, name in reversed(items[max(0, k - 64) : k + 1]):
            if a <= t <= b:
                return name
        return None

    def breakdown(self) -> dict:
        """The ten device operations that took most time in the window, and
        the window's idle time by what the calling thread was inside (the
        innermost span, then the innermost operator)."""
        w0, w1 = self.window
        by_op: dict[str, float] = {}
        for a, b, name, _ in self.device:
            if w0 <= a and b <= w1:
                by_op[name[:120]] = by_op.get(name[:120], 0.0) + (b - a) / 1e6
        idle: dict[str, float] = {}
        cursor = w0
        for a, b in self.busy_union + [(w1, w1)]:
            a, b = max(a, w0), min(b, w1)
            if a > cursor:
                mid = (cursor + a) / 2
                label = "/".join(x for x in (self._innermost(self.marks, mid),
                                             self._innermost(self.ops, mid)) if x)
                idle[label or "host"] = idle.get(label or "host", 0.0) + (a - cursor) / 1e6
            cursor = max(cursor, b)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(idle)}


class Profiler:
    """Profiles operations [first, first + count) of a window; ``trace`` is
    the reduced Trace once the last of them has run."""

    def __init__(self, enabled: bool, first: int, count: int, devices: int = 1) -> None:
        self.enabled, self.first, self.count, self.devices = enabled, first, count, devices
        self.trace: Trace | None = None
        self._prof = None

    def before(self, i: int) -> None:
        if self.enabled and i == self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts, acc_events=True)
            self._prof.__enter__()

    def after(self, i: int) -> None:
        if self._prof is not None and i == self.first + self.count - 1:
            self.close()

    def close(self) -> None:
        """Stop (if running) and read the trace; the export goes through a
        temporary file that is deleted at once."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f)["traceEvents"], self.devices)
        self._prof = None

    @contextlib.contextmanager
    def op(self, i: int):
        """One operation of the window, inside a ``bench.op`` span."""
        self.before(i)
        with span("bench.op"):
            yield
        self.after(i)
