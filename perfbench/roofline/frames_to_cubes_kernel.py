"""K1 (csrc/relayout.cu): one GOP's frames in (1 byte a pixel), the cubes
out in the compute dtype, and one int32 pixel sum per cube."""


def essential_bytes(f: dict) -> float:
    n = f["cubes"] * f["cube"]
    return n + n * f["value_bytes"] + 4 * f["cubes"]
