"""Milliseconds per GOP that an encode waits in the encoder's ``finish()``
after its last GOP was pushed: the host drain (DEFLATE-9 of the
Exp-Golomb bytes on the parallel sink's pool, or the turbo drain's
zlib-6 of the nibble planes) catching up with the device.  Summed over the
profiled files on the benchmark's host clock.  Layer: host entropy."""


def read(run, part):
    gops = run.gops.get(part, 0)
    waits = [r.get("finish_s") for r in run.records]
    if not gops or not waits or any(w is None for w in waits):
        return None
    return 1e3 * sum(waits) / gops
