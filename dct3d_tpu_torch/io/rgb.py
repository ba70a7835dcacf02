"""RGB planar split / mix (a copy of ``dct3d_tpu.io.rgb``;
tests/test_torch_host.py pins it to the original).

The codec is single-channel; color video is handled by splitting interleaved
RGB into three planar files, coding each independently, and mixing back —
the workflow of the reference's RGBUtils (RGBUtils.java:39-131: `split`
produces `.red/.green/.blue`, `mix` reverses).  Here the byte shuffles are
single NumPy strided copies instead of per-byte loops.
"""

from __future__ import annotations

import numpy as np

PLANE_SUFFIXES = (".red", ".green", ".blue")


def split_array(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(T, H, W, 3) interleaved -> three (T, H, W) planes."""
    return rgb[..., 0].copy(), rgb[..., 1].copy(), rgb[..., 2].copy()


def mix_array(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Three (T, H, W) planes -> (T, H, W, 3) interleaved."""
    return np.stack([r, g, b], axis=-1)


def split_file(path: str, out_prefix: str | None = None) -> tuple[str, str, str]:
    """Split an interleaved-RGB raw file into .red/.green/.blue planar files.

    Geometry-free: operates on the flat byte stream like RGBUtils.java:39-90.
    """
    prefix = out_prefix or path
    data = np.fromfile(path, dtype=np.uint8)
    data = data[: data.size - data.size % 3].reshape(-1, 3)
    outs = tuple(prefix + s for s in PLANE_SUFFIXES)
    for i, out in enumerate(outs):
        data[:, i].tofile(out)
    return outs


def mix_files(prefix: str, out_path: str) -> str:
    """Mix .red/.green/.blue planar files back into interleaved RGB."""
    planes = [np.fromfile(prefix + s, dtype=np.uint8) for s in PLANE_SUFFIXES]
    n = min(p.size for p in planes)
    out = np.empty((n, 3), dtype=np.uint8)
    for i, p in enumerate(planes):
        out[:, i] = p[:n]
    out.tofile(out_path)
    return out_path
