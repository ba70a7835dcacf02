"""DEFLATE's lazy parse (csrc/deflate.cu): the GOP's bytes and matches in,
its uint32 tokens out.  The token count depends on the content's matches,
which the facts do not give: counted at its floor, one token a 258 bytes.
Bound by each lane's sequential parse of its part, not by these bytes."""


def essential_bytes(f: dict) -> float:
    n = f["stream_bits"] / 8
    return n + 4 * n + 4 * n / 258
