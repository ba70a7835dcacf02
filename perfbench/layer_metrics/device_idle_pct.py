"""Share of a phase's calls (the benchmark's ``bench.<part>`` spans) in
which nothing ran on the device: no kernel, copy or fill.  Layer: the
device; from the profiler's trace."""


def read(run, part):
    spans = run.trace.spans(f"bench.{part}")
    total = sum(b - a for a, b in spans)
    if not total:
        return None
    return 100.0 * (1.0 - run.trace.busy(spans) / total)
