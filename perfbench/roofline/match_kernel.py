"""DEFLATE's match search (csrc/deflate.cu): the GOP's bytes and its three
uint16 links a byte in, one uint32 match a byte out.  Bound by the walk
down the chains (up to depth * 5 / 4 dependent shared-memory reads a
position), not by these bytes: its share of the roofline reads low."""


def essential_bytes(f: dict) -> float:
    n = f["stream_bits"] / 8
    return n + 3 * 2 * n + 4 * n
