"""Milliseconds per GOP that the calling thread spends staging a GOP for
the device: the program's ``stage_in`` span (pinned buffer, host copy,
H2D enqueue), inside ``dispatch``, in the encoders' push and the
decoders' step.  Layer: entry points and pipeline; the program's span."""

from perfbench.program_spans import ms_per_gop


def read(run, part):
    return ms_per_gop(run, part, "stage_in")
