"""Benchmark of dct3d_tpu_torch, the PyTorch and CUDA port of the codec.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line (``run.py``).  Everything that belongs to one configuration, traffic
mix, per-layer metric or kernel sits in a file of its own, found by name:

  configs/<config>.json          codec settings, geometry, source
  traffic/<traffic>.json         content generator, loop and its sizes
  loops/<loop>.py                one loop of requests (class Loop)
  content/<content>.py           one content generator (generate)
  layer_metrics/<metric>.py      one reader per per-layer metric
  roofline/<kernel symbol>.py    one kernel's essential bytes
  roofline/peaks.json            the card's published peaks

The yardstick lives here too, frozen against later edits of the program:
the content generators (content/), the rate arithmetic (quality.py), the
profiler wrapper and trace reduction (trace.py), and the plain float64
reference that decides ``correct`` (reference.py, checks.py).  Only
``sut.py`` imports the program.
"""
