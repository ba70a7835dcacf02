"""Device microseconds per GOP of a phase: the union of the kernels'
intervals inside the phase's calls (``bench.<part>`` spans), summed over
the run's cards, over the GOPs those calls encoded, decoded or sought.
Layer: the device step; from the profiler's trace."""


def read(run, part):
    spans = run.trace.spans(f"bench.{part}")
    gops = run.gops.get(part, 0)
    if not spans or not gops:
        return None
    return run.trace.busy(spans, kernels_only=True) * run.trace.devices / gops
