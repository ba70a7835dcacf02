"""Milliseconds per GOP that the calling thread blocks on the encoder's
drain of GOPs (device wait, D2H, the hand-off to the sink; in the turbo
profile the whole member): the program's ``wait_drainer`` span, in push()'s
backpressure and in finish()'s wait for the GOPs in flight.  Layer: entry
points and pipeline; the program's span."""

from perfbench.program_spans import ms_per_gop


def read(run, part):
    return ms_per_gop(run, part, "wait_drainer")
