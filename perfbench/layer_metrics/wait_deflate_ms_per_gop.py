"""Milliseconds per GOP that the reference encoder's finish() blocks on the
DEFLATE sink's last blocks, after the drainer has handed over every GOP:
the program's ``wait_deflate`` span.  Layer: host entropy; the program's
span."""

from perfbench.program_spans import ms_per_gop


def read(run, part):
    return ms_per_gop(run, part, "wait_deflate")
