"""K2 (csrc/group_pack.cu): one GOP's int32 values and one int32 bit phase
per 256-value group in; the groups' Exp-Golomb bits out, counted at the
GOP's stream size (the words shared by two groups once)."""


def essential_bytes(f: dict) -> float:
    n = f["cubes"] * f["cube"]
    return 4 * n + 4 * (n // 256) + f["stream_bits"] / 8
