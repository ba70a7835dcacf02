"""DEFLATE's compaction (csrc/deflate.cu): the segments' uint32 tokens in,
one run of them out, each counted at its floor of one token a 258 bytes
(the count depends on the content's matches, which the facts do not give)."""


def essential_bytes(f: dict) -> float:
    n = f["stream_bits"] / 8
    return 2 * 4 * n / 258
