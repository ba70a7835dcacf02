"""Milliseconds per GOP of DEFLATE work: the reference encoder's StageTimer
stage ``deflate`` (each block's compression, on the parallel sink's pool
workers, summed over them), over the profiled files.  A busy time, not a
wait: with several workers it can exceed the encode's wall time.  A
program whose timer has no ``sink_push`` stage timed only the hand-off
under ``deflate`` and gives nothing.  Layer: host entropy; the program's
StageTimer."""


def read(run, part):
    timers = [r.get("timer") for r in run.records]
    gops = run.gops.get(part, 0)
    if not gops or not timers or any(t is None or "sink_push" not in t for t in timers):
        return None
    return 1e3 * sum(t.get("deflate", 0.0) for t in timers) / gops
