"""DEFLATE's emit (csrc/deflate.cu): the blocks' descriptors and uint32
symbols in, the span's words out.  The symbols are counted at their floor
of one a 258 bytes, and the span at DEFLATE's floor of one byte a 1,032
(both depend on the content's matches, which the facts do not give)."""


def essential_bytes(f: dict) -> float:
    n = f["stream_bits"] / 8
    symbols = n / 258
    return 4 * symbols + 4096 * max(1.0, symbols / 16384) + n / 1032
