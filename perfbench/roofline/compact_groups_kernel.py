"""K6 (csrc/exc_pack.cu): one GOP's int32 values in; out, one int32 count
per 256-value group and, for each exception the GOP holds, its uint8 lane
and int16 value (the table slots it leaves empty are not counted)."""


def essential_bytes(f: dict) -> float:
    n = f["cubes"] * f["cube"]
    return 4 * n + 4 * (n // 256) + 3 * f["exceptions"]
