"""Milliseconds per GOP that the calling thread waits for the next GOP's
nibble plane from the host entropy pool (the C Exp-Golomb decode; in the
turbo profile the member's decompression): the program's ``entropy_wait``
span.  Layer: host entropy; the program's span."""

from perfbench.program_spans import ms_per_gop


def read(run, part):
    return ms_per_gop(run, part, "entropy_wait")
