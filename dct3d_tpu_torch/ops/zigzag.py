"""3D diagonal-slice ("zigzag") coefficient ordering (copy of
``dct3d_tpu.ops.zigzag``; tests/test_torch_host.py pins the tables equal).

The reference enumerates all cube positions grouped by constant coordinate-sum
planes ``x + y + z == target_sum`` to maximize trailing-zero runs before
entropy coding (reference: CubeUtils.java:7-41, CubeUtils.c:5-46; rationale
comment Encoder.java:96-97).  Within a plane the order is y outer, z middle,
x inner.  Bitstream compatibility requires this exact order, so the golden
tests in tests/test_zigzag.py pin it down.

On the device the ordering is a constant 512-entry permutation.  It is never applied
as a gather at runtime: the permutation is folded into the rows/columns of the
encode/decode matrices (see ops/dct.py), making it free.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def diagonal_slices(width: int, height: int, depth: int) -> np.ndarray:
    """All (x, y, z) cube positions in diagonal-slice order.

    Returns an int32 array of shape (width*height*depth, 3) with columns
    (x, y, z), matching the reference enumeration (CubeUtils.java:15-36):
    ascending coordinate-sum planes; within a plane y outer, z middle,
    x inner.
    """
    positions = []
    max_sum = (width - 1) + (height - 1) + (depth - 1)
    for target in range(max_sum + 1):
        max_x = min(width - 1, target)
        max_y = min(height - 1, target)
        max_z = min(depth - 1, target)
        min_x = max(0, target - (max_y + max_z))
        min_y = max(0, target - (max_x + max_z))
        min_z = max(0, target - (max_y + max_x))
        for y in range(min_y, max_y + 1):
            for z in range(min_z, max_z + 1):
                for x in range(min_x, max_x + 1):
                    if x + y + z == target:
                        positions.append((x, y, z))
    out = np.asarray(positions, dtype=np.int32)
    assert out.shape == (width * height * depth, 3)
    return out


@functools.lru_cache(maxsize=None)
def zigzag_flat_indices(width: int, height: int, depth: int) -> np.ndarray:
    """Flat cube indices (layout [z][y][x], i.e. x fastest) in zigzag order.

    ``cube_flat[zigzag_flat_indices(...)]`` lists coefficients in bitstream
    order; this matches the reference's indexing
    ``offset + x + y*width + z*face_size`` (Encoder.java:104-107,
    encoder.c:64-66).
    """
    pos = diagonal_slices(width, height, depth)
    return (pos[:, 0] + pos[:, 1] * width + pos[:, 2] * width * height).astype(
        np.int32
    )


@functools.lru_cache(maxsize=None)
def inverse_zigzag_flat_indices(width: int, height: int, depth: int) -> np.ndarray:
    """Inverse permutation: position of each flat cube index in the stream."""
    perm = zigzag_flat_indices(width, height, depth)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv
