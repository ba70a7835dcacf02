"""K7 and K8 (csrc/wire.cu, one kernel): a GOP's nibble plane, one byte per
two values, transposed between the cube-major and the coefficient-pair
major layout: read once, written once."""


def essential_bytes(f: dict) -> float:
    return f["cubes"] * f["cube"]
