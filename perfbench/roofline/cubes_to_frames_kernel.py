"""K4 (csrc/relayout.cu): one GOP's pixel cubes in, in the compute dtype,
clamped uint8 frames out."""


def essential_bytes(f: dict) -> float:
    n = f["cubes"] * f["cube"]
    return n * f["value_bytes"] + n
