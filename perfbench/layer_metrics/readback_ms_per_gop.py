"""Milliseconds per GOP that the calling thread spends taking a decoded GOP
back from the device: the program's ``readback`` span (the wait on the
GOP's D2H event and the copy into the output frames).  Layer: entry
points and pipeline; the program's span."""

from perfbench.program_spans import ms_per_gop


def read(run, part):
    return ms_per_gop(run, part, "readback")
