"""Milliseconds per GOP that the calling thread spends inflating the
reference stream (GOP-parallel from the index's sync offsets, or one
serial zlib pass): the program's ``inflate`` span in the decode.  Layer:
host entropy; the program's span."""

from perfbench.program_spans import ms_per_gop


def read(run, part):
    return ms_per_gop(run, part, "inflate")
