"""DEFLATE's adler32 sums (csrc/deflate.cu): the GOP's bytes in, two
int64 sums out."""


def essential_bytes(f: dict) -> float:
    return f["stream_bits"] / 8 + 16
