"""What the per-layer readers of the program's own spans share: the time
the calling thread spent inside one span that the program opens
(``dct3d_tpu_torch.profiling.trace``) during a phase's calls.

The spans sit on the thread that calls the library, the one whose ranges
``trace.Trace`` keeps, and on the profiler's clock, so the overlap of the
span's merged intervals with the phase's ``bench.<part>`` spans is the
phase's time in that span.  A program without the span (an older commit)
gives nothing.
"""

from perfbench.trace import overlap


def ms_per_gop(run, part: str, name: str) -> float | None:
    """Milliseconds per GOP of phase ``part`` inside the program's span
    ``name``, over the GOPs the phase's profiled calls handled; None when
    the trace holds no such span or the phase no call."""
    phase = run.trace.spans(f"bench.{part}")
    inner = run.trace.spans(name)
    gops = run.gops.get(part, 0)
    if not phase or not inner or not gops:
        return None
    return overlap(inner, phase) / 1e3 / gops
