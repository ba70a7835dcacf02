"""DEFLATE's block plans (csrc/deflate.cu): the uint32 symbols in, one
4 KiB descriptor a block of 16,384 symbols out, the symbols counted at
their floor of one a 258 bytes (the count depends on the content's
matches, which the facts do not give).  Bound by one thread's Huffman
build a block, not by these bytes: its share of the roofline reads low."""


def essential_bytes(f: dict) -> float:
    symbols = f["stream_bits"] / 8 / 258
    return 4 * symbols + 4096 * max(1.0, symbols / 16384)
