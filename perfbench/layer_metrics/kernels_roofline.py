"""Share of the memory roofline that the port's own kernels reach in a
phase: their essential bytes at the card's HBM rate, over the device time
they took inside the phase's calls.  Every kernel is memory-bound (a few
operations per byte).  Bytes come from ``roofline/<symbol>.py`` for each
launch, with the per-GOP facts of the profiled GOPs; a port kernel without
such a file is named on standard error and left out; library kernels
(cuBLAS, PyTorch's own) are not port kernels.  Layer: the kernels."""

import sys

from perfbench import spec
from perfbench.trace import port_symbol


def read(run, part):
    spans = run.trace.spans(f"bench.{part}")
    if not spans:
        return None
    nbytes = seconds = 0.0
    missing = set()
    for a, b, name in run.trace.kernels_in(spans):
        symbol = port_symbol(name)
        if symbol is None:
            continue
        fn = spec.kernel_bytes(symbol)
        if fn is None:
            missing.add(symbol)
            continue
        nbytes += fn(run.facts[part])
        seconds += (b - a) / 1e6
    if missing:
        print(f"note: port kernels with no roofline file, left out of "
              f"kernels_roofline.{part}: {sorted(missing)}", file=sys.stderr)
    if not seconds:
        return None
    return 100.0 * nbytes / spec.peaks()["hbm_bytes_per_s"] / seconds
