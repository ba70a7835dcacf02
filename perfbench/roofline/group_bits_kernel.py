"""group_bits (csrc/group_pack.cu): one GOP's int32 values in, one int32
codeword-bit total per 256-value group out."""


def essential_bytes(f: dict) -> float:
    n = f["cubes"] * f["cube"]
    return 4 * n + 4 * (n // 256)
