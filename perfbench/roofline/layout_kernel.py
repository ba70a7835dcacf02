"""DEFLATE's layout (csrc/deflate.cu): the blocks' 4 KiB descriptors in,
their start bits out (one int32 each), with the blocks counted at their
floor, a block of 16,384 symbols of 258 bytes.  One thread walks the
blocks: bound by that walk, not by these bytes."""


def essential_bytes(f: dict) -> float:
    blocks = max(1.0, f["stream_bits"] / 8 / 258 / 16384)
    return (4096 + 4) * blocks
