"""DEFLATE's chains (csrc/deflate.cu): the GOP's bytes in, three uint16
links a byte out.  Bound by the insertion's dependent steps, one warp a
hash table, not by these bytes: its share of the roofline reads low."""


def essential_bytes(f: dict) -> float:
    n = f["stream_bits"] / 8
    return n + 3 * 2 * n
