"""K5 (csrc/group_pack.cu): one int32 code and one int32 width per
codeword and one int32 bit phase per 256-codeword group in; the groups'
bits out, counted at the GOP's stream size."""


def essential_bytes(f: dict) -> float:
    n = f["cubes"] * f["cube"]
    return 8 * n + 4 * (-(-n // 256)) + f["stream_bits"] / 8
