"""The readers of the program's own spans and stages, on a small synthetic
trace: the span's time inside the phase's ``bench.<part>`` spans over the
phase's GOPs, and nothing where the program opened no such span (an
older commit)."""

import pytest

from perfbench import run, spec
from perfbench.trace import Trace

MAIN, WORKER = 1, 2


def _event(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _run(events, gops=4, records=()):
    return run.RunData(Trace(events), list(records), {"encode": gops, "decode": gops}, {})


@pytest.mark.parametrize("metric,span", [
    ("stage_in_ms_per_gop.encode", "stage_in"),
    ("stage_in_ms_per_gop.decode", "stage_in"),
    ("wait_drainer_ms_per_gop.encode", "wait_drainer"),
    ("wait_deflate_ms_per_gop.encode", "wait_deflate"),
    ("inflate_ms_per_gop.decode", "inflate"),
    ("entropy_wait_ms_per_gop.decode", "entropy_wait"),
    ("readback_ms_per_gop.decode", "readback"),
])
def test_span_reader(metric, span):
    read, part = spec.layer_reader(metric)
    other = "decode" if part == "encode" else "encode"
    events = [
        _event(f"bench.{part}", 1000, 10000), _event(f"bench.{part}", 20000, 10000),
        _event(f"bench.{other}", 40000, 10000),
        # 2 ms and 1 ms inside the phase, 1.5 ms of it across the phase's
        # end, twice over in one place (nested), 3 ms in the other phase and
        # 5 ms on a worker thread: 2 + 1 + 0.5 = 3.5 ms in the phase.
        _event(span, 2000, 2000), _event(span, 2500, 1000), _event(span, 25000, 1000),
        _event(span, 10500, 1500), _event(span, 41000, 3000), _event(span, 21000, 5000, WORKER),
    ]
    assert read(_run(events), part) == pytest.approx(3.5 / 4)
    assert read(_run(events, gops=0), part) is None
    without = [e for e in events if e["name"] != span]
    assert read(_run(without), part) is None


def test_deflate_busy_reader():
    read, part = spec.layer_reader("deflate_busy_ms_per_gop.encode")
    events = [_event("bench.encode", 0, 1000)]
    timers = [{"dispatch": 0.1, "sink_push": 0.01, "deflate": 1.2},
              {"dispatch": 0.1, "sink_push": 0.01, "deflate": 0.8}]
    assert read(_run(events, 8, [{"timer": t} for t in timers]), part) == pytest.approx(250.0)
    # A timer without sink_push timed only the hand-off under "deflate".
    old = [{"timer": {"dispatch": 0.1, "deflate": 0.01}}] * 2
    assert read(_run(events, 8, old), part) is None
    assert read(_run(events, 8, [{"timer": None}]), part) is None
    assert read(_run(events, 0, [{"timer": t} for t in timers]), part) is None
