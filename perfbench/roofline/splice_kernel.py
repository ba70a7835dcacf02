"""K3 (csrc/splice.cu): the groups' bits in and the spliced stream out,
each counted at the GOP's stream size, and two int32 word offsets per
256-value group."""


def essential_bytes(f: dict) -> float:
    n = f["cubes"] * f["cube"]
    return 2 * f["stream_bits"] / 8 + 8 * (n // 256)
