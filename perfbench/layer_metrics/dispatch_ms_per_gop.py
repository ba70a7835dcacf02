"""Milliseconds per GOP that the calling thread spends handing GOPs to the
device: the reference encoder's StageTimer stage ``dispatch`` (pin, H2D
copy and the encode step's launches), summed over the profiled files.
Layer: entry points and pipeline; the program's own span.  Encoders
without a StageTimer (turbo) give nothing."""


def read(run, part):
    timers = [r.get("timer") for r in run.records]
    gops = run.gops.get(part, 0)
    if not gops or not timers or any(t is None or "dispatch" not in t for t in timers):
        return None
    return 1e3 * sum(t["dispatch"] for t in timers) / gops
